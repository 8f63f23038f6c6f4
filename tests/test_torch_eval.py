"""The port's eval package (``f5_tts_tpu_torch/eval/``) against the JAX
package's: the WER core, the metalist parsers and the prompt preparation
give JAX's values exactly (the reference mel within the mel tests' bound,
``tests/test_torch_ops.py``: atol 1e-5, rtol 5e-5); ECAPA-TDNN on JAX's
``state_dict`` is JAX's bitwise; the batch driver on the same weights and
noise as JAX's driver writes the same files into the same directory, each
wav within 2 int16 steps (the slice tests' bound, ``tests/test_torch_aot.py``);
the model adapters run against fakes, as ``tests/test_eval.py`` runs JAX's.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from f5_tts_tpu.eval import metrics as JMET
from f5_tts_tpu.eval import testsets as JTS
from f5_tts_tpu_torch.audio.io import load_wav, save_wav
from f5_tts_tpu_torch.eval import metrics as TMET
from f5_tts_tpu_torch.eval import testsets as TTS

SR = 24000

PAIRS = [
    ("the cat sat on the mat", "the cat sat on a mat", "en"),
    ("Hello, world!", "hello world", "en"),
    ("One two three four.", "one too three", "en"),
    ("", "extra words", "en"),
    ("", "", "en"),
    ("a b c d e f", "f e d c b a", "en"),
    ("你好世界", "你好地球", "zh"),
    ("今天天气很好。", "今天 天气 很 好", "zh"),
    ("我们去公园吧", "我们去学校", "zh"),
]


@pytest.mark.parametrize("truth,hypo,lang", PAIRS)
def test_wer_core_equals_jax(truth, hypo, lang):
    assert TMET._norm_text(truth, lang) == JMET._norm_text(truth, lang)
    assert TMET.word_error_rate(truth, hypo, lang) == JMET.word_error_rate(truth, hypo, lang)
    a, b = list(truth), list(hypo)
    assert TMET.edit_distance(a, b) == JMET.edit_distance(a, b)


def _tone(path, freq=220.0, seconds=0.4, amp=0.2, sr=SR):
    t = np.arange(int(sr * seconds)) / sr
    save_wav(str(path), (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32), sr)
    return str(path)


def test_metalist_parsing_equals_jax(tmp_path):
    seed = tmp_path / "meta.lst"
    seed.write_text("utt1|prompt text|wavs/p1.wav|generate this\n"
                    "utt2|其他|/abs/p2.wav|生成这个|/abs/g2.wav\n", encoding="utf-8")
    assert TTS.get_seedtts_testset_metainfo(str(seed)) == \
        JTS.get_seedtts_testset_metainfo(str(seed))
    ls = tmp_path / "ls.lst"
    ls.write_text("1-2-0001\t3.0\tref words here.\t3-4-0002\t4.0\tgen words here.\n"
                  "5-6-0003\t2.5\tmore ref.\t7-8-0004\t6.1\tmore gen.\n", encoding="utf-8")
    got = TTS.get_librispeech_test_clean_metainfo(str(ls), "/ls/test-clean")
    assert got == JTS.get_librispeech_test_clean_metainfo(str(ls), "/ls/test-clean")
    assert got[0][2] == "/ls/test-clean/1/2/1-2-0001.flac"


REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "examples", "assets", "basic_ref_en.wav")


def _seedtts(root, n=4, lang="en"):
    """A seeded seedtts ``meta.lst`` under ``root/seedtts_testset/<lang>``:
    prompts cut from the example speech clip (one made quiet, so the RMS
    rescale runs; a pure tone's near-empty mel bins would hold the fp32
    DFTs' cancellation error, not the port's) and ground-truth wavs."""
    d = root / "seedtts_testset" / lang
    d.mkdir(parents=True)
    speech, sr = load_wav(REF)
    rng = np.random.default_rng(11)
    lines = []
    for i in range(n):
        clip = speech[i * sr // 4: i * sr // 4 + int((0.9 + 0.1 * i) * sr)]
        save_wav(str(d / f"p{i}.wav"), clip * (0.3 if i == 1 else 1.0), sr)
        _tone(d / f"g{i}.wav", 260 + 10 * i, 1.1 + 0.05 * i)
        words = " ".join(["alpha", "beta", "gamma", "delta"][j % 4]
                         for j in rng.integers(0, 4, 5 + i))
        lines.append(f"utt{i}|a prompt sentence {i}.|p{i}.wav|{words}.|{d}/g{i}.wav\n")
    (d / "meta.lst").write_text("".join(lines), encoding="utf-8")
    return str(d / "meta.lst")


class _JaxRefMel:
    """The fields JAX's ``prepare_eval_prompts`` reads of an engine, with
    JAX's own ``InferenceEngine.ref_mel``."""

    def __init__(self, cfg, buckets):
        from f5_tts_tpu.infer import engine as JE

        self.model_cfg, self.hop, self.buckets = cfg, cfg.mel.hop_length, buckets
        self.ref_mel = JE.InferenceEngine.ref_mel.__get__(self)


@pytest.mark.parametrize("truth", [False, True])
def test_prepare_eval_prompts_equals_jax(tmp_path, truth):
    from f5_tts_tpu.models.configs import MODEL_CONFIGS as JCONFIGS
    from f5_tts_tpu_torch.infer.engine import DEFAULT_BUCKETS, InferenceEngine
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer

    meta = TTS.get_seedtts_testset_metainfo(_seedtts(tmp_path))
    vocab, _ = get_tokenizer(None, "pinyin")
    eng = InferenceEngine(CFM(MODEL_CONFIGS["F5TTS_Tiny"].arch), MODEL_CONFIGS["F5TTS_Tiny"])
    got = TTS.prepare_eval_prompts(meta, eng, vocab, "pinyin", use_truth_duration=truth,
                                   min_s=1.0)
    want = JTS.prepare_eval_prompts(meta, _JaxRefMel(JCONFIGS["F5TTS_Tiny"], DEFAULT_BUCKETS),
                                    vocab, "pinyin", use_truth_duration=truth, min_s=1.0)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.utt, g.duration, g.ref_frames, g.ref_rms) == \
            (w.utt, w.duration, w.ref_frames, w.ref_rms)
        np.testing.assert_array_equal(g.text_ids, w.text_ids)
        assert g.ref_mel.shape == w.ref_mel.shape
        np.testing.assert_allclose(g.ref_mel, w.ref_mel, atol=1e-5, rtol=5e-5)


def test_ecapa_on_jax_state_dict_is_bitwise_jax():
    from f5_tts_tpu.eval.ecapa_tdnn import ECAPA_TDNN as JECAPA
    from f5_tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        ref = JECAPA(feat_dim=24, channels=64, emb_dim=32)
        for m in ref.modules():  # non-trivial running statistics
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
        feats = torch.randn(3, 57, 24)
    port = ECAPA_TDNN(feat_dim=24, channels=64, emb_dim=32)
    port.load_state_dict(ref.state_dict())
    ref.eval(), port.eval()
    with torch.no_grad():
        assert torch.equal(port(feats), ref(feats))


def test_ecapa_small_without_s3prl_raises_as_jax(monkeypatch):
    from f5_tts_tpu.eval.ecapa_tdnn import ECAPA_TDNN_SMALL as JSMALL
    from f5_tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN_SMALL

    monkeypatch.setitem(sys.modules, "s3prl", None)
    monkeypatch.setitem(sys.modules, "s3prl.nn", None)
    for fn in (JSMALL, ECAPA_TDNN_SMALL):
        with pytest.raises(RuntimeError, match="s3prl"):
            fn()
    assert ECAPA_TDNN_SMALL(feat_dim=24, feat_type="features").linear.out_features == 256


def test_eval_infer_batch_matches_jax_driver(tmp_path, monkeypatch):
    """Both drivers on one seedtts list, the same checkpoint files (the
    port's seeded F5TTS_Tiny with its zero-initialized projections filled,
    and its seeded Vocos) and JAX's noise for the seed.  JAX's test process
    holds 8 CPU devices, so its driver runs a data mesh of 8 at batch 8;
    the port runs one process at batch 8 (``mesh=None``)."""
    import jax

    from f5_tts_tpu.eval import eval_infer_batch as JDRV
    from f5_tts_tpu.utils import compile_cache
    from f5_tts_tpu_torch.eval import eval_infer_batch as TDRV
    from f5_tts_tpu_torch.infer import engine as TE
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos

    cfg = MODEL_CONFIGS["F5TTS_Tiny"]
    model = _seeded(lambda: CFM(cfg.arch), 0)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(0))
    ckpt, voc = str(tmp_path / "model.pt"), str(tmp_path / "vocos.pt")
    torch.save(model.state_dict(), ckpt)
    torch.save(_seeded(Vocos, 1).state_dict(), voc)
    _seedtts(tmp_path / "data")

    def jax_noise(seeds, n, d, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(s)), (n, d))) for s in seeds])).to(device)

    monkeypatch.setattr(TE, "draw_noise", jax_noise)
    monkeypatch.setattr(compile_cache, "enable_persistent_cache", lambda *a, **k: None)
    args = ["-t", "seedtts_test_en", "-n", "F5TTS_Tiny", "-p", ckpt, "--vocoder_local_path", voc,
            "-nfe", "2", "-s", "7", "--metalst_root", str(tmp_path / "data"),
            "--batch_size", "8"]
    want_dir = JDRV.main(args + ["--results_root", str(tmp_path / "jax")])
    got_dir = TDRV.main(args + ["--results_root", str(tmp_path / "port"), "--device", "cpu"])
    assert os.path.relpath(got_dir, tmp_path / "port") == os.path.relpath(want_dir, tmp_path / "jax")
    files = sorted(os.listdir(got_dir))
    assert files == sorted(os.listdir(want_dir)) == ["rtf.txt"] + [f"utt{i}.wav" for i in range(4)]
    keys = [line.split(":")[0] for line in open(os.path.join(got_dir, "rtf.txt"))]
    assert keys == [line.split(":")[0] for line in open(os.path.join(want_dir, "rtf.txt"))]
    for f in files[1:]:
        (a, sa), (b, sb) = load_wav(os.path.join(got_dir, f)), load_wav(os.path.join(want_dir, f))
        a16, b16 = (np.round(w * 32768.0).astype(np.int32) for w in (a, b))
        assert sa == sb == SR and a16.shape == b16.shape and np.abs(a).max() > 0
        assert np.abs(a16 - b16).max() <= 2, (f, np.abs(a16 - b16).max())


def test_run_wer_adapters_with_fakes(tmp_path, monkeypatch):
    calls = {}

    class FakeWhisperModel:
        def __init__(self, model_dir, device="cpu"):
            calls["model_dir"] = model_dir

        def transcribe(self, wav_path, beam_size=5, language="en"):
            text = " Hello world." if "a.wav" in wav_path else " goodbye now"
            return [types.SimpleNamespace(text=text)], {"language": language}

    class FakeAutoModel:
        def __init__(self, model, disable_update=True):
            calls["zh_model"] = model

        def generate(self, input, batch_size_s=300, disable_pbar=True):
            return [{"text": "你好地球"}]

    monkeypatch.setitem(sys.modules, "faster_whisper",
                        types.SimpleNamespace(WhisperModel=FakeWhisperModel))
    monkeypatch.setitem(sys.modules, "funasr", types.SimpleNamespace(AutoModel=FakeAutoModel))
    items = [("utt_a", _tone(tmp_path / "a.wav"), "hello world"),
             ("utt_b", _tone(tmp_path / "b.wav", 300.0), "goodbye friend")]
    got = TMET.run_wer(items, "en", str(tmp_path / "ck"))
    assert got == JMET.run_wer(items, "en", str(tmp_path / "ck"))
    assert [r["wer"] for r in got] == [0.0, 0.5]
    assert calls["model_dir"].endswith("Systran/faster-whisper-large-v3")
    zh = [("utt", items[0][1], "你好世界")]
    assert TMET.run_wer(zh, "zh") == JMET.run_wer(zh, "zh")
    assert calls["zh_model"].endswith("paraformer-zh")


def test_adapters_raise_actionable_errors_without_their_tools(monkeypatch):
    for mod in ("faster_whisper", "funasr"):
        monkeypatch.setitem(sys.modules, mod, None)
    for lang, tool in (("en", "faster-whisper"), ("zh", "funasr")):
        with pytest.raises(RuntimeError, match=tool):
            TMET.load_asr_model(lang)


def _fake_s3prl(monkeypatch):
    class FakeUpstream(torch.nn.Module):
        def __init__(self, name):
            super().__init__()
            assert name == "wavlm_large"

        def forward(self, wav, lens):
            b, t = wav.shape
            frames = max(4, t // 2048)
            base = wav[:, : frames * 2048].reshape(b, frames, -1).mean(-1, keepdim=True)
            return [base * torch.linspace(0.5, 1.5, 1024, device=wav.device)], None

    s3prl_nn = types.ModuleType("s3prl.nn")
    s3prl_nn.S3PRLUpstream = FakeUpstream
    monkeypatch.setitem(sys.modules, "s3prl", types.SimpleNamespace(nn=s3prl_nn))
    monkeypatch.setitem(sys.modules, "s3prl.nn", s3prl_nn)


def test_run_sim_with_a_fake_wavlm_equals_jax(tmp_path, monkeypatch):
    from f5_tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN

    _fake_s3prl(monkeypatch)
    ckpt = tmp_path / "wavlm_ecapa.pt"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        torch.save({"model": ECAPA_TDNN(feat_dim=1024, channels=512, emb_dim=256).state_dict()},
                   str(ckpt))
    gen = _tone(tmp_path / "gen.wav", 220.0, 0.6)
    prompt = _tone(tmp_path / "prompt.wav", 330.0, 0.5)
    items = [("same", gen, gen), ("diff", gen, prompt)]
    got = TMET.run_sim(items, str(ckpt), device="cpu")
    want = JMET.run_sim(items, str(ckpt))
    assert got[0]["sim"] == pytest.approx(1.0, abs=1e-5)
    assert [r["wav"] for r in got] == ["same", "diff"]
    np.testing.assert_allclose([r["sim"] for r in got], [r["sim"] for r in want], atol=1e-6)
    if not torch.cuda.is_available():  # the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMET.run_sim(items, str(ckpt))


def test_utmos_and_eval_testset_drivers_with_fakes(tmp_path, monkeypatch):
    """``run_utmos`` and ``eval_utmos.main`` on a fake hub predictor, and
    ``eval_seedtts_testset.main`` (WER) on a fake whisper: the jsonl files
    and the means JAX's drivers write."""
    from f5_tts_tpu.eval import eval_seedtts_testset as JSEED
    from f5_tts_tpu.eval import eval_utmos as JUT
    from f5_tts_tpu_torch.eval import eval_seedtts_testset as TSEED
    from f5_tts_tpu_torch.eval import eval_utmos as TUT

    def fake_hub_load(repo, name, trust_repo=True):
        assert name == "utmos22_strong"
        return lambda wav, sr: torch.tensor([3.5 + 0.1 * float(wav.abs().mean())])

    monkeypatch.setattr(torch.hub, "load", fake_hub_load)
    gen = tmp_path / "gen"
    gen.mkdir()
    for i in range(3):
        _tone(gen / f"utt{i}.wav", 200.0 + 30 * i)
    out = {}
    for tag, mod in (("port", TUT), ("jax", JUT)):
        mean = mod.main(["--audio_dir", str(gen)])
        out[tag] = (mean, open(gen / "_utmos_results.jsonl").read())
    assert out["port"] == out["jax"] and 3.0 < out["port"][0] < 4.0

    class FakeWhisperModel:
        def __init__(self, model_dir, device="cpu"):
            pass

        def transcribe(self, wav_path, beam_size=5, language="en"):
            return [types.SimpleNamespace(text=" alpha beta")], {}

    monkeypatch.setitem(sys.modules, "faster_whisper",
                        types.SimpleNamespace(WhisperModel=FakeWhisperModel))
    _seedtts(tmp_path / "data", n=3)
    for tag, mod in (("port", TSEED), ("jax", JSEED)):
        mean = mod.main(["-e", "wer", "-l", "en", "-g", str(gen),
                         "--metalst_root", str(tmp_path / "data")])
        rows = [json.loads(x) for x in open(gen / "_wer_results.jsonl") if x.startswith("{")]
        out[tag] = (mean, rows)
    assert out["port"] == out["jax"] and len(out["port"][1]) == 3
