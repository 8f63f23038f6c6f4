"""The port's serving slice as a whole against the JAX engine.

``engine._sample_and_decode_from_wav`` (ref-mel extraction, the NFE-16
fused-CFG Euler sampler, the Vocos decode, the int16 output) runs on both
sides with the same carried-over F5TTS_Tiny DiT and Vocos weights, the same
int16 reference wav, and the noise JAX draws for each row handed to the
port.  fp32 on the CPU.  Then the host-side helpers, and the public
``F5TTS(...).infer`` on the CPU.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.infer import engine as JE
from f5_tts_tpu.infer import pipeline as JP
from f5_tts_tpu.models import vocos as JV
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.text.tokenizer import get_tokenizer as jax_get_tokenizer
from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.infer import pipeline as TP
from f5_tts_tpu_torch.infer.api import F5TTS
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
from f5_tts_tpu_torch.utils.ckpt import load_into, vocos_state_from_jax_params
from tests.test_torch_dit import carried

REF = "examples/assets/basic_ref_en.wav"


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sample_and_decode_from_wav_matches_jax_engine():
    """Mel MAE < 1e-3 (tests/test_parity_e2e.py's bound for the fp32
    sampler); int16 wav within 2 LSB (the float waveforms agree to ~1e-5
    before the int16 truncation, which can flip a sample by one step)."""
    jcfg, tcfg = JAX_CONFIGS["F5TTS_Tiny"], MODEL_CONFIGS["F5TTS_Tiny"]
    params, dit = carried(jcfg.arch, seed=3)
    vparams = JV.init(jax.random.PRNGKey(1))
    voc = Vocos().eval().requires_grad_(False)
    load_into(voc, vocos_state_from_jax_params(jax.tree.map(np.asarray, vparams)))

    wav, sr = load_wav(REF)
    wav = wav[: int(0.8 * sr)]
    hop, n, b = 256, 256, 2
    ref_frames = len(wav) // hop
    S = JE.pick_bucket(ref_frames + 1) * hop + 1024
    padded = np.pad(np.pad(wav, 512, mode="reflect"), (0, S))[:S]
    wav_i16 = np.broadcast_to(np.round(padded * 32767.0).astype(np.int16), (b, S)).copy()
    scale = np.ones((b,), np.float32)
    lens = np.full((b,), ref_frames, np.int32)
    rng = np.random.default_rng(8)
    text = np.full((b, n), -1, np.int32)
    text[0, :40] = rng.integers(0, 2545, 40)
    text[1, :25] = rng.integers(0, 2545, 25)
    duration = JE._clamp_duration(np.array([200, 140], np.int32), text, lens, n)
    seeds = np.array([11, 12], np.int32)
    jopts = JE.EngineOptions(nfe_step=16)
    mel_j, wav_j = JE._sample_and_decode_from_wav(
        params, vparams, jcfg, jopts, jnp.asarray(wav_i16), jnp.asarray(scale), jnp.asarray(lens),
        jnp.asarray(text), jnp.asarray(duration), jnp.asarray(seeds), n)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(int(s)), (n, 100)))
                      for s in seeds])
    mel_t, wav_t = TE.sample_and_decode_from_wav(
        dit, voc, tcfg, TE.EngineOptions(nfe_step=16), _t(wav_i16), _t(scale), _t(lens),
        _t(text), _t(duration), _t(noise), n)
    mae = np.abs(mel_t.numpy() - np.asarray(mel_j)).mean()
    assert mae < 1e-3, mae
    diff = np.abs(wav_t.numpy().astype(np.int32) - np.asarray(wav_j).astype(np.int32))
    assert wav_t.dtype == torch.int16 and diff.max() <= 2, diff.max()


def test_host_helpers_match_jax():
    for d in (1, 255, 256, 257, 1500, 4096):
        assert TE.pick_bucket(d) == JE.pick_bucket(d)
    with pytest.raises(ValueError):
        TE.pick_bucket(5000)
    text = np.full((3, 64), -1, np.int32)
    text[0, :10] = 1
    text[1, :63] = 1
    lens = np.array([20, 5, 60], np.int32)
    dur = np.array([25, 30, 100], np.int32)
    np.testing.assert_array_equal(TE._clamp_duration(dur, text, lens, 64),
                                  JE._clamp_duration(dur, text, lens, 64))
    for args in [(200, "Some call me nature.", ["Hello there, how are you?", "Hi."], 1.0, None),
                 (150, "参考文本。", ["你好世界，今天天气很好。"], 0.8, None),
                 (150, "ref", ["x"], 1.0, 2.5)]:
        assert TP.estimate_durations(*args, 24000, 256) == JP.estimate_durations(*args, 24000, 256)
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(k).astype(np.float32) for k in (5000, 300, 9000)]
    for cf in (0.0, 0.15):
        np.testing.assert_array_equal(TP.cross_fade_stitch(waves, cf, 24000),
                                      JP.cross_fade_stitch(waves, cf, 24000))


@pytest.mark.parametrize("tokenizer", ["pinyin", "char"])
def test_text_to_ids_on_mixed_text_matches_jax(tokenizer):
    texts = ["Hello 世界, this is F5-TTS.", "我们一起去北京吧！ OK?", "不要一个人走。"]
    vocab, _ = get_tokenizer(None, tokenizer)
    jvocab, _ = jax_get_tokenizer(None, tokenizer)
    assert vocab == jvocab
    np.testing.assert_array_equal(TP.text_to_ids(texts, vocab, tokenizer),
                                  JP.text_to_ids(texts, jvocab, tokenizer))


def test_trim_wavs_lengths_match_jax():
    cfg = MODEL_CONFIGS["F5TTS_Tiny"]
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu")
    jeng = JE.InferenceEngine.__new__(JE.InferenceEngine)
    jeng.hop, jeng.vocoder_type = cfg.mel.hop_length, "vocos"
    duration, lens = np.array([300, 90], np.int32), np.array([40, 40], np.int32)
    wav = np.zeros((2, 1024 * 256), np.int16)
    tw, tg = tts.engine._trim_wavs(torch.from_numpy(wav), duration, lens)
    jw, jg = jeng._trim_wavs(jnp.asarray(wav), duration, lens)
    assert tg == jg and [len(w) for w in tw] == [len(w) for w in jw] == [259 * 256, 49 * 256]


def test_f5tts_infer_on_cpu_returns_finite_wav_of_expected_length():
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=4)
    seen = []
    inner = tts.engine.generate_batch_from_wavs

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out[2])
        return out

    tts.engine.generate_batch_from_wavs = recording
    wav, sr, spec = tts.infer(REF, "Some call me nature, others call me mother nature.",
                              "I don't really care what you call me.", seed=0,
                              show_info=lambda *a: None)
    (gen_frames,) = seen
    assert sr == 24000 and np.isfinite(wav).all()
    assert len(wav) == (gen_frames[0] - 1) * 256
    assert spec.shape == (100, gen_frames[0])


def test_rows_are_batch_invariant_per_seed():
    """Each row's noise comes from its own seeded generator, so a row gives
    the same mel alone or batched with another reference (fp32 matmuls
    batch differently: atol 1e-4)."""
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=4)
    eng = tts.engine
    wav, _ = load_wav(REF)
    refs = [wav[:12000], wav[6000:20000]]
    ids = [np.arange(5, 25, dtype=np.int32), np.arange(40, 52, dtype=np.int32)]
    mels, wavs, gfs = eng.generate_batch_from_wavs(refs, ids, [150, 160], seeds=[3, 4])
    for i in range(2):
        m1, w1, g1 = eng.generate_batch_from_wavs([refs[i]], [ids[i]], [[150, 160][i]],
                                                  seeds=[[3, 4][i]])
        assert g1 == [gfs[i]] and len(w1[0]) == len(wavs[i]) == (gfs[i] - 1) * 256
        np.testing.assert_allclose(m1[0], mels[i], atol=1e-4)


def test_streaming_yields_every_chunk():
    """The streaming path runs one engine call per text chunk and yields all
    of each chunk's audio, in pieces of at most chunk_size samples."""
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=2)
    calls = []
    inner = tts.engine.generate_batch_from_wavs

    def recording(*a, **kw):
        out = inner(*a, **kw)
        calls.append(out[2])
        return out

    tts.engine.generate_batch_from_wavs = recording
    wav, sr = load_wav(REF)
    chunks = ["First part of the text.", "And a second part."]
    pieces = list(TP.infer_batch_process(tts.engine, (wav, sr), "Some call me nature. ", chunks,
                                         tts.vocab, tokenizer=tts.tokenizer,
                                         opts=TP.PipelineOptions(seed=1), streaming=True,
                                         chunk_size=4096))
    assert len(calls) == 2 and all(len(g) == 1 for g in calls)
    assert all(s == 24000 and 0 < len(p) <= 4096 for p, s in pieces)
    audio = np.concatenate([p for p, _ in pieces])
    assert len(audio) == sum((g[0] - 1) * 256 for g in calls) and np.isfinite(audio).all()
