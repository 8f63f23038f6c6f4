"""The port's serving surface against the JAX package, on the CPU: hub
resolution, speech editing, the dynamic batcher, the batch server, the
HTTP server and the engine's warm-up (which on the CPU runs each call).

Mirrors ``tests/test_hub.py``, ``tests/test_batcher.py``,
``tests/test_serve.py`` and the JAX speech-edit path.  Nothing touches the
network: hub lookups run against a fake local HF cache with
``HF_HUB_OFFLINE=1``.  The engines are F5TTS_Tiny at NFE 2-4 in fp32.
Tolerances: a row batched with others against the same row alone, 2e-4 on
the wav (``tests/test_batcher.py``'s: fp32 matmuls of other row counts
round differently); speech edit against JAX, 2 int16 steps on the wav
(``test_sample_and_decode_from_wav_matches_jax_engine``'s).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from f5_tts_tpu.infer import batcher as JB
from f5_tts_tpu.infer import engine as JE
from f5_tts_tpu.infer import serve as JS
from f5_tts_tpu.infer import speech_edit as JSE
from f5_tts_tpu.models import vocos as JV
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.text.tokenizer import get_tokenizer as jax_get_tokenizer
from f5_tts_tpu.utils import hub as jhub
from f5_tts_tpu_torch.audio.io import load_wav, save_wav
from f5_tts_tpu_torch.infer import batcher as TB
from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.infer import http_server as H
from f5_tts_tpu_torch.infer import pipeline as TP
from f5_tts_tpu_torch.infer import serve as TS
from f5_tts_tpu_torch.infer import speech_edit as TSE
from f5_tts_tpu_torch.infer.api import F5TTS
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
from f5_tts_tpu_torch.utils import hub
from f5_tts_tpu_torch.utils.ckpt import load_into, vocos_state_from_jax_params
from f5_tts_tpu_torch.utils.seed import seed_everything
from tests.test_torch_dit import carried

REF = "examples/assets/basic_ref_en.wav"
REF_TEXT = "Some call me nature, others call me mother nature."
WAV_ATOL = 2e-4


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def tts():
    """F5TTS_Tiny with seeded random weights on the CPU, NFE 2."""
    return F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=2)


def _reqs(n, d=100, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ref = rng.standard_normal((40 + int(rng.integers(0, 30)), d)).astype(np.float32)
        text = rng.integers(0, 200, size=20 + int(rng.integers(0, 20))).astype(np.int32)
        out.append((ref, text, int(rng.integers(120, 250)), i))
    return out


# ----------------------------------------------------------------------- hub

def _fake_cache(tmp_path, repo_id: str, files: dict[str, bytes]) -> str:
    """A real-layout HF cache holding one revision of one repo."""
    cache = tmp_path / "hf_cache"
    repo_dir = cache / ("models--" + repo_id.replace("/", "--"))
    rev = "0123456789abcdef0123456789abcdef01234567"
    (repo_dir / "refs").mkdir(parents=True, exist_ok=True)
    (repo_dir / "refs" / "main").write_text(rev)
    snap = repo_dir / "snapshots" / rev
    for name, data in files.items():
        p = snap / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    return str(cache)


@pytest.mark.parametrize("model", ["F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base",
                                   "F5TTS_MMDiT_Base", "F5TTS_Tiny", "custom"])
@pytest.mark.parametrize("mel", ["vocos", "bigvgan"])
def test_hub_names_equal_jax(model, mel):
    assert hub.model_hub_spec(model, mel) == jhub.model_hub_spec(model, mel)
    assert hub.VOCODER_HUB == jhub.VOCODER_HUB and hub.WHISPER_REPO == jhub.WHISPER_REPO


@pytest.mark.parametrize("uri", ["hf://SWivid/F5-TTS/F5TTS_v1_Base/model_1250000.safetensors",
                                 "hf://org/repo/a.pt", "hf://only-org", "hf://org/repo"])
def test_parse_hf_uri_equals_jax(uri):
    try:
        want = jhub.parse_hf_uri(uri)
    except ValueError:
        with pytest.raises(ValueError):
            hub.parse_hf_uri(uri)
        return
    assert hub.parse_hf_uri(uri) == want


def test_resolve_from_local_cache_offline(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    cache = _fake_cache(tmp_path, "SWivid/F5-TTS",
                        {"F5TTS_v1_Base/model_1250000.safetensors": b"fake"})
    got = hub.resolve_checkpoint("F5TTS_v1_Base", hf_cache_dir=cache)
    assert got and open(got, "rb").read() == b"fake"
    assert got == jhub.resolve_checkpoint("F5TTS_v1_Base", hf_cache_dir=cache)
    assert hub.resolve_checkpoint("E2TTS_Base", hf_cache_dir=cache) is None  # a miss
    vcache = _fake_cache(tmp_path / "v", "charactr/vocos-mel-24khz", {"pytorch_model.bin": b"v"})
    assert hub.resolve_vocoder("vocos", hf_cache_dir=vcache).endswith("pytorch_model.bin")
    assert hub.resolve_vocoder("bigvgan", hf_cache_dir=vcache) is None
    assert hub.resolve_vocoder("encodec", hf_cache_dir=vcache) is None


def test_api_resolves_hf_uri_checkpoint(tmp_path, monkeypatch):
    """F5TTS(ckpt_file="hf://...") with a flat arch dict loads a release
    straight from the local cache; with no vocoder in it, it warns and
    serves mel-only, as JAX does."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    arch = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=1)
    _, vocab_size = get_tokenizer(None, "pinyin")
    src = F5TTS(model="tiny", model_cfg=arch, init_random=True, device="cpu")
    state = {"ema_model." + k: v for k, v in src.engine.model.state_dict().items()}
    local = tmp_path / "model_tiny.pt"
    torch.save({"ema_model_state_dict": state}, str(local))
    cache = _fake_cache(tmp_path, "someone/tiny-f5", {"model_tiny.pt": local.read_bytes()})
    with pytest.warns(UserWarning, match="no vocoder"):
        tts = F5TTS(model="tiny", model_cfg=arch, ckpt_file="hf://someone/tiny-f5/model_tiny.pt",
                    hf_cache_dir=cache, device="cpu")
    assert tts.model_cfg.arch.dim == 64 and tts.model_cfg.arch.text_num_embeds == vocab_size
    assert tts.engine.vocoder is None
    for k, v in tts.engine.model.state_dict().items():
        torch.testing.assert_close(v, state["ema_model." + k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        F5TTS(model="tiny", model_cfg=arch, ckpt_file="hf://someone/tiny-f5/nope.pt",
              hf_cache_dir=cache, device="cpu")


def test_api_missing_checkpoint_message(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(ValueError, match="SWivid/F5-TTS"):
        F5TTS(model="F5TTS_v1_Base", device="cpu", hf_cache_dir=str(tmp_path / "empty"))


def test_seed_everything_seeds_numpy_and_torch():
    seed_everything(3)
    a = (np.random.rand(), torch.rand(()).item())
    seed_everything(3)
    assert a == (np.random.rand(), torch.rand(()).item())


# -------------------------------------------------------------- speech edit

@pytest.mark.parametrize("parts,fix", [([(0.2, 0.5)], None), ([(0.1, 0.3), (0.6, 0.9)], None),
                                       ([(0.1, 0.3), (0.6, 0.9)], [0.5, 0.1]),
                                       ([(0.0, 0.4)], [1.0])])
def test_build_edit_masks_equals_jax(parts, fix):
    got = TSE.build_edit_masks(100, parts, fix, 24000, 256)
    want = JSE.build_edit_masks(100, parts, fix, 24000, 256)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_edit_speech_matches_jax():
    """Carried F5TTS_Tiny DiT and Vocos weights, NFE 4, the same seed: both
    draw the noise from numpy's default_rng, so the wavs agree."""
    jcfg, tcfg = JAX_CONFIGS["F5TTS_Tiny"], MODEL_CONFIGS["F5TTS_Tiny"]
    params, dit = carried(jcfg.arch, seed=3)
    vparams = JV.init(jax.random.PRNGKey(1))
    voc = Vocos().eval().requires_grad_(False)
    load_into(voc, vocos_state_from_jax_params(jax.tree.map(np.asarray, vparams)))
    cfm = CFM(tcfg.arch)
    cfm.transformer = dit
    jeng = JE.InferenceEngine(params, jcfg, vocoder_params=vparams,
                              options=JE.EngineOptions(nfe_step=4))
    teng = TE.InferenceEngine(cfm, tcfg, vocoder=voc, options=TE.EngineOptions(nfe_step=4))
    vocab, _ = get_tokenizer(None, "char")
    jvocab, _ = jax_get_tokenizer(None, "char")
    args = (REF, REF_TEXT, "Some call me nature, others call me father time.",
            [(0.9, 1.4), (2.0, 2.2)])
    want, sr_j = JSE.edit_speech(jeng, jvocab, "char", *args, fix_durations=[0.7, 0.2], seed=5)
    got, sr_t = TSE.edit_speech(teng, vocab, "char", *args, fix_durations=[0.7, 0.2], seed=5)
    assert sr_t == sr_j and got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - np.asarray(want)).max() <= 2 / 32767


# ------------------------------------------------------------------ engine

def test_warmup_all_on_cpu_runs_eagerly_and_keeps_results(tts):
    eng = tts.engine
    wav, _ = load_wav(REF)
    ids = [np.arange(5, 25, dtype=np.int32)]
    before = eng.generate_batch_from_wav(wav[:20000], ids, [150], seeds=[3])
    calls = []
    inner = eng.generate_batch_from_wav

    def recording(*a, **kw):
        calls.append(len(a[1]))
        return inner(*a, **kw)

    eng.generate_batch_from_wav = recording
    try:
        eng.warmup_all(buckets=(256,), batch_sizes=(1, 2))
        eng.warmup(n_frames=256, text_len=8)
    finally:
        del eng.generate_batch_from_wav
    assert calls == [1, 2] and eng.graphs == {}  # run, not captured, on the CPU
    after = eng.generate_batch_from_wav(wav[:20000], ids, [150], seeds=[3])
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1][0], before[1][0])


# ----------------------------------------------------------------- batcher

@pytest.mark.parametrize("max_batch", [1, 2, 3, 4, 6, 8, 9])
def test_batch_size_ladder_equals_jax(max_batch):
    assert TB._batch_size_ladder(max_batch) == JB._batch_size_ladder(max_batch)


def test_concurrent_requests_share_batches_and_match_unbatched(tts):
    eng = tts.engine
    reqs = _reqs(6)
    want = [eng.generate_batch([r], [t], [d], seeds=[s], fetch_mel=False)[1][0]
            for r, t, d, s in reqs]
    batcher = TB.DynamicBatcher(eng, max_batch=4, queue_delay_ms=200.0)
    got = [None] * len(reqs)
    try:
        def client(i):
            ref, text, dur, seed = reqs[i]
            got[i] = batcher.generate(text, dur, seed=seed, ref_mel=ref)[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = batcher.stats()
    finally:
        batcher.close()
    assert stats["requests"] == 6 and stats["batches"] < 6 and stats["avg_batch_size"] > 1.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=WAV_ATOL)


def test_zero_delay_still_serves(tts):
    batcher = TB.DynamicBatcher(tts.engine, max_batch=4, queue_delay_ms=0.0)
    try:
        ref, text, dur, seed = _reqs(1)[0]
        wav, gf, mel = batcher.generate(text, dur, seed=seed, ref_mel=ref, fetch_mel=True)
        assert len(wav) == (gf - 1) * 256 > 0 and np.isfinite(wav).all()
        assert mel is not None and mel.ndim == 2
    finally:
        batcher.close()


def test_batcher_error_paths(tts):
    batcher = TB.DynamicBatcher(tts.engine, max_batch=2, queue_delay_ms=50.0)
    try:
        with pytest.raises(ValueError):  # out of range: raised at submit
            batcher.submit(np.zeros((5,), np.int32), duration=10**9, seed=0,
                           ref_mel=np.zeros((8, 100), np.float32))
        with pytest.raises(ValueError):
            batcher.submit(np.zeros(3, np.int32), 100)
        with pytest.raises(ValueError):
            batcher.submit(np.zeros(3, np.int32), 100, ref_mel=np.zeros((4, 100), np.float32),
                           ref_wav=np.zeros(100, np.float32))
        # an engine failure fans out to the group's callers; the scheduler survives
        fut = batcher.submit(np.zeros((5,), np.int32), duration=100, seed=0,
                             ref_mel=np.zeros((8, 7), np.float32))
        with pytest.raises(Exception):
            fut.result(timeout=60)
        ref, text, dur, seed = _reqs(1)[0]
        assert len(batcher.generate(text, dur, seed=seed, ref_mel=ref, timeout=60)[0]) > 0
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros(3, np.int32), 100, ref_mel=np.zeros((4, 100), np.float32))


def test_close_during_submits_resolves_every_future(tts):
    """Clients keep submitting while the batcher closes: each submit either
    raises "closed" or returns a future that resolves (a result or
    "batcher closed"); none is left pending."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the threads as finely as the interpreter can
    try:
        _close_during_submits(tts)
    finally:
        sys.setswitchinterval(switch)


def _close_during_submits(tts):
    batcher = TB.DynamicBatcher(tts.engine, max_batch=4, queue_delay_ms=30.0)
    ref, text, dur, _ = _reqs(1)[0]
    futures, refused, stop = [], [], threading.Event()

    def client(seed):
        while not stop.is_set():
            try:
                futures.append(batcher.submit(text, dur, seed=seed, ref_mel=ref))
            except RuntimeError:
                refused.append(seed)
                return
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    batcher.close()
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and futures
    for f in futures:
        try:
            f.result(timeout=60)
        except RuntimeError as e:
            assert "batcher closed" in str(e)
    assert all(f.done() for f in futures)


def test_close_while_a_submit_is_queueing(tts):
    """A submit that has passed its closed check but not yet queued its item
    when close() runs: the item is still served (JAX's batcher could queue
    it after the scheduler stopped and leave its future pending)."""
    batcher = TB.DynamicBatcher(tts.engine, max_batch=4, queue_delay_ms=0.0)
    entered = threading.Event()

    class SlowPut:
        def __init__(self, q):
            self.q = q

        def put(self, item):
            if item is not None:
                entered.set()
                time.sleep(0.3)
            self.q.put(item)

        def __getattr__(self, name):
            return getattr(self.q, name)

    batcher._q = SlowPut(batcher._q)
    ref, text, dur, seed = _reqs(1)[0]
    box = {}
    th = threading.Thread(target=lambda: box.update(
        fut=batcher.submit(text, dur, seed=seed, ref_mel=ref)))
    th.start()
    assert entered.wait(30)
    batcher.close()
    th.join(timeout=30)
    assert not th.is_alive()
    wav, gf, _ = box["fut"].result(timeout=30)
    assert len(wav) == (gf - 1) * 256 > 0


def test_batched_engine_forwards_attribute_writes(tts):
    eng = tts.engine
    batcher = TB.DynamicBatcher(eng, max_batch=2, queue_delay_ms=0.0)
    old = eng.options
    try:
        beng = TB.BatchedEngine(batcher)
        beng.options = dataclasses.replace(eng.options, nfe_step=7)
        assert eng.options.nfe_step == 7 and beng.options.nfe_step == 7
        assert "options" not in vars(beng) and beng.model_cfg is eng.model_cfg
    finally:
        eng.options = old
        batcher.close()


def test_batched_engine_through_pipeline_matches_engine(tts):
    """The facade drops into the shared pipeline unchanged (the per-row and
    shared-reference wav entries included) and gives the engine's audio."""
    eng = tts.engine
    wav, sr = load_wav(REF)
    opts = TP.PipelineOptions(seed=11)
    args = ((wav, sr), REF_TEXT, ["I don't really care.", "What you call me."], tts.vocab)
    want, sr1, _ = TP.infer_batch_process(eng, *args, tokenizer=tts.tokenizer, opts=opts)
    beng = TB.wrap_engine(eng, max_batch=4, queue_delay_ms=10.0)
    try:
        got, sr2, _ = TP.infer_batch_process(beng, *args, tokenizer=tts.tokenizer, opts=opts)
        refs = [wav[:15000], wav[5000:22000]]
        ids = [np.arange(5, 25, dtype=np.int32), np.arange(40, 52, dtype=np.int32)]
        per_row = beng.generate_batch_from_wavs(refs, ids, [150, 160], seeds=[3, 4],
                                                fetch_mel=False)[1]
    finally:
        beng.batcher.close()
    assert sr1 == sr2
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
    for i in range(2):
        alone = eng.generate_batch_from_wavs([refs[i]], [ids[i]], [[150, 160][i]],
                                             seeds=[[3, 4][i]], fetch_mel=False)[1][0]
        np.testing.assert_allclose(per_row[i], alone, atol=WAV_ATOL)


# ----------------------------------------------------------------- servers

def test_batch_server_equals_engine(tts):
    eng = tts.engine
    d = eng.model_cfg.mel.n_mel_channels
    rng = np.random.default_rng(0)
    reqs = [TS.Request(ref_mel=rng.standard_normal((40 + i, d)).astype(np.float32),
                       text_ids=rng.integers(0, 200, size=20 + i).astype(np.int32),
                       duration=int(rng.integers(120, 250)), seed=i) for i in range(6)]
    srv = TS.BatchServer(eng, batch_size=4)
    wavs, lats = srv.run(reqs)
    assert len(wavs) == 6 and len(lats) == 2
    for w, r in zip(wavs, reqs):
        want = eng.generate_batch([r.ref_mel], [r.text_ids], [r.duration], seeds=[r.seed],
                                  fetch_mel=False)[1][0]
        np.testing.assert_allclose(w, want, atol=WAV_ATOL)
    serial, _ = srv.run(reqs, overlap=1)
    for a, b in zip(serial, wavs):
        np.testing.assert_array_equal(a, b)
    srv.warmup_all(buckets=(256,))
    TS.BatchServer(eng, tensor_parallel=True)  # no model axis: the engine stays whole, as JAX
    assert not eng.tensor_parallel
    with pytest.raises(TypeError):  # a mesh is a torch DeviceMesh
        TS.BatchServer(eng, mesh=object())


def test_rtf_report_equals_jax():
    rng = np.random.default_rng(1)
    wavs = [rng.standard_normal(int(rng.integers(1000, 50000))).astype(np.float32)
            for _ in range(7)]
    lats = list(rng.uniform(0.05, 0.9, size=5))
    assert TS.rtf_report(wavs, lats) == JS.rtf_report(wavs, lats)
    assert TS.rtf_report(wavs, lats, 16000) == JS.rtf_report(wavs, lats, 16000)


@pytest.mark.parametrize("max_batch", [1, 4])
def test_http_server_roundtrip(tts, tmp_path, max_batch):
    """``serve`` on localhost (any free port), with and without the dynamic
    batcher: /health, /tts (WAV bytes, the same audio as the pipeline at
    the same seed), /stats, 404s, then a shutdown that gives the F5TTS its
    engine back."""
    import http.client
    import json

    eng = tts.engine
    box = {}
    ready = threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=H.serve, args=(tts, REF, REF_TEXT, "127.0.0.1", 0),
                          kwargs=dict(max_batch=max_batch, queue_delay_ms=1.0, ready=on_ready),
                          daemon=True)
    th.start()
    assert ready.wait(60)
    server = box["server"]
    port = server.server_address[1]
    try:
        text = "make me some audio via http."
        wav, sr = H.request_tts(text, "127.0.0.1", port, seed=5)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read()) == {"status": "ok"}
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        server.shutdown()
        th.join(timeout=60)
    assert tts.engine is eng
    if max_batch == 1:
        assert stats == {"batching": "off"}
    else:
        assert stats["requests"] == 1 and stats["batches"] == 1
    from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text

    ref, ref_text = preprocess_ref_audio_text(REF, REF_TEXT)
    want, _, _ = TP.infer_process(eng, ref, ref_text, text, tts.vocab, tokenizer=tts.tokenizer,
                                  opts=TP.PipelineOptions(seed=5), show_info=_quiet)
    pcm = (np.clip(want, -1, 1) * 32767).astype("<i2").astype(np.float32) / 32767.0
    assert sr == 24000 and len(wav) == len(pcm) > 1000
    np.testing.assert_allclose(wav, pcm, atol=WAV_ATOL + 1 / 32767)


def test_wav_bytes_roundtrip(tmp_path):
    wav = np.sin(np.arange(4000) / 9.0).astype(np.float32) * 0.5
    path = tmp_path / "a.wav"
    path.write_bytes(H.wav_bytes(wav, 24000))
    back, sr = load_wav(str(path))
    assert sr == 24000 and np.abs(back - wav).max() < 1e-4
    save_wav(str(tmp_path / "b.wav"), wav, 24000)
