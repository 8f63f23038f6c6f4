"""The BigVGAN serving slice as a whole against the JAX engine: a tiny DiT
on bigvgan mels and a narrow BigVGAN at hop 256, fp32 on the CPU.

``engine._sample_and_decode_from_wav`` (the bigvgan ref mel, the NFE-8
sampler, the BigVGAN decode over the whole bucket row, the int16 output)
runs on both sides with the same weights, the same int16 reference wav and
the noise JAX draws for each row; then the trimmed wav (``gf * hop``
samples for BigVGAN) and the port's engine and ``F5TTS`` end to end.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from f5_tts_tpu.infer import engine as JE
from f5_tts_tpu.models import bigvgan as JB
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.ops.mel import MelConfig as JMelConfig
from f5_tts_tpu.utils.ckpt import bigvgan_params_from_state, params_from_state
from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.models import bigvgan as TB
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.ops.mel import MelConfig
from f5_tts_tpu_torch.utils import ckpt as TK
from tests.test_torch_bigvgan import weight_normed_state

REF = "examples/assets/basic_ref_en.wav"
# a narrow BigVGAN with the published hop (8 x 8 x 4 = 256): 32 -> 4 channels
VOC = dict(num_mels=100, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX config, port config, JAX DiT params, port DiT, JAX BigVGAN
    params, port BigVGAN): the port's seeded DiT (gates made non-zero)
    carried into JAX by its own loader, which compiles nothing."""
    jcfg = dataclasses.replace(JAX_CONFIGS["F5TTS_Tiny"], mel=JMelConfig(mel_spec_type="bigvgan"))
    tcfg = dataclasses.replace(MODEL_CONFIGS["F5TTS_Tiny"], mel=MelConfig(mel_spec_type="bigvgan"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        dit = CFM(tcfg.arch).transformer.eval().requires_grad_(False)
    randomize_zero_init(dit, torch.Generator().manual_seed(7))
    params = params_from_state({k: v.numpy() for k, v in dit.state_dict().items()}, jcfg.arch)
    state = weight_normed_state(TB.BigVGANConfig(**VOC), seed=4, scale=0.5)
    vparams = bigvgan_params_from_state(state, JB.BigVGANConfig(**VOC))
    voc = TK.load_bigvgan_state(TB.BigVGAN(TB.BigVGANConfig(**VOC)), state).eval()
    return jcfg, tcfg, params, dit, vparams, voc


def test_sample_and_decode_from_wav_matches_jax_engine():
    """Mel MAE < 1e-3 (tests/test_torch_slice.py's bound); int16 wav within
    2 steps (the float waveforms agree to ~1e-6 before the truncation, which
    can flip a sample by one step)."""
    jcfg, tcfg, params, dit, vparams, voc = _models()
    wav, sr = load_wav(REF)
    wav = wav[: int(0.8 * sr)]
    hop, n, b, pad = 256, 160, 2, (1024 - 256) // 2  # n: any length, not only a bucket
    ref_frames = len(wav) // hop
    S = JE.pick_bucket(ref_frames + 1) * hop + 1024
    padded = np.pad(np.pad(wav, pad, mode="reflect"), (0, S))[:S]
    wav_i16 = np.broadcast_to(np.round(padded * 32767.0).astype(np.int16), (b, S)).copy()
    scale = np.ones((b,), np.float32)
    lens = np.full((b,), ref_frames, np.int32)
    rng = np.random.default_rng(9)
    text = np.full((b, n), -1, np.int32)
    text[0, :40] = rng.integers(0, 2545, 40)
    text[1, :25] = rng.integers(0, 2545, 25)
    duration = JE._clamp_duration(np.array([150, 120], np.int32), text, lens, n)
    seeds = np.array([21, 22], np.int32)
    mel_j, wav_j = JE._sample_and_decode_from_wav(
        params, vparams, jcfg, JE.EngineOptions(nfe_step=8), jnp.asarray(wav_i16),
        jnp.asarray(scale), jnp.asarray(lens), jnp.asarray(text), jnp.asarray(duration),
        jnp.asarray(seeds), n, vocoder_type="bigvgan", vocoder_cfg=JB.BigVGANConfig(**VOC))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(int(s)), (n, 100)))
                      for s in seeds])
    mel_t, wav_t = TE.sample_and_decode_from_wav(
        dit, voc, tcfg, TE.EngineOptions(nfe_step=8), _t(wav_i16), _t(scale), _t(lens),
        _t(text), _t(duration), _t(noise), n, vocoder_type="bigvgan")
    assert np.abs(mel_t.numpy() - np.asarray(mel_j)).mean() < 1e-3
    assert wav_t.shape == np.asarray(wav_j).shape == (b, n * hop)
    assert np.abs(np.asarray(wav_j)).max() > 1000  # a signal, not silence or a clamp
    diff = np.abs(wav_t.numpy().astype(np.int32) - np.asarray(wav_j).astype(np.int32))
    assert wav_t.dtype == torch.int16 and diff.max() <= 2, diff.max()

    # the trimmed rows: gf * hop samples for BigVGAN (Vocos: (gf - 1) * hop)
    model = CFM(tcfg.arch)
    TK.load_into(model.transformer, dit.state_dict())
    eng = TE.InferenceEngine(model, tcfg, vocoder=voc)
    assert eng.vocoder_type == "bigvgan"
    jeng = JE.InferenceEngine.__new__(JE.InferenceEngine)
    jeng.hop, jeng.vocoder_type = hop, "bigvgan"
    tw, tg = eng._trim_wavs(wav_t, duration, lens)
    jw, jg = jeng._trim_wavs(jnp.asarray(wav_j), duration, lens)
    assert tg == jg and [len(w) for w in tw] == [len(w) for w in jw] == [g * hop for g in tg]
    for a, c in zip(tw, jw):
        np.testing.assert_allclose(a, c, atol=2 / 32767)

    # the engine end to end (on the CPU: the module-level functions)
    _, wavs, gfs = eng.generate_batch_from_wav(wav, [text[0, :40]], [150], seeds=[1])
    assert len(wavs[0]) == gfs[0] * hop and np.isfinite(wavs[0]).all()


def test_f5tts_bigvgan_model_cfg_serves_on_cpu():
    """``F5TTS(model_cfg=<a ModelConfig with the bigvgan mel>)`` builds
    BigVGAN v2 at its published widths as the vocoder; with the narrow one
    in its place (a full-width decode takes ~20 s on the CPU) it serves a
    request: ``gf * 256`` samples; the spectrogram covers the generated
    frames."""
    cfg = dataclasses.replace(MODEL_CONFIGS["F5TTS_Tiny"], mel=MelConfig(mel_spec_type="bigvgan"))
    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model="F5TTS_Tiny", model_cfg=cfg, init_random=True, device="cpu", nfe_step=2)
    assert isinstance(tts.engine.vocoder, TB.BigVGAN)
    assert tts.engine.vocoder.cfg == TB.BigVGANConfig()
    tts.engine.vocoder = _models()[-1]
    seen = []
    inner = tts.engine.generate_batch_from_wavs

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out[2])
        return out

    tts.engine.generate_batch_from_wavs = recording
    wav, sr, spec = tts.infer(REF, "Some call me nature.", "Hi.", seed=0,
                              show_info=lambda *a: None)
    (gen_frames,) = seen
    assert sr == 24000 and np.isfinite(wav).all() and len(wav) == gen_frames[0] * 256
    assert spec.shape == (100, gen_frames[0])
