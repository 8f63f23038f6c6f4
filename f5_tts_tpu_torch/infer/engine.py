"""Inference engine: bucketed text -> waveform generation.

JAX counterpart: ``f5_tts_tpu/infer/engine.py``.  ``sample_and_decode_from_wav``
is the counterpart of the fused ``_sample_and_decode_from_wav`` graph:
ref-mel extraction, ``cfm.sample`` (the NFE Euler loop over the fused-CFG
DiT) and the Vocos decode, each on the engine's device.  It takes the noise
as an explicit tensor; the engine's public methods draw it per row from
``torch.Generator(device).manual_seed(seed)``, so a row's noise depends only
on its seed and the bucket, not on the batch it rides in.

Target durations round up to frame buckets; every dynamic length is a mask.
The DiT runs in the engine's dtype (bf16 on the card), the vocoder in fp32.
Options that belong to later slices of the port (W8A8, the time-parallel
window, the einsum-tap convpos) raise if set.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from f5_tts_tpu_torch.models import cfm, vocos
from f5_tts_tpu_torch.models.configs import ModelConfig
from f5_tts_tpu_torch.models.dit import fuse_for_inference
from f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_prepadded, num_frames, stft_pad_amount

SILENCE_FLOOR = float(np.log(1e-5))

DEFAULT_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)


def pick_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"duration {n} frames exceeds the largest bucket {buckets[-1]}")


@dataclass(frozen=True)
class EngineOptions:
    """Serving knobs (the JAX fields of later slices must stay unset)."""

    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    use_epss: bool = True
    ode_method: str = "euler"  # "euler" | "midpoint"
    backend: str = "auto"  # attention backend
    quantize: bool = False  # W8A8: not ported yet
    time_parallel_window: int = 0  # Picard window: not ported yet
    convpos_taps: bool = False  # mesh-serving convpos: not ported yet

    def __post_init__(self):
        for name in ("quantize", "time_parallel_window", "convpos_taps"):
            if getattr(self, name):
                raise NotImplementedError(f"EngineOptions.{name} is not ported yet; "
                                          "see ROADMAP.md")

    def sample_opts(self) -> cfm.SampleOptions:
        return cfm.SampleOptions(steps=self.nfe_step, cfg_strength=self.cfg_strength,
                                 sway_sampling_coef=self.sway_sampling_coef,
                                 use_epss=self.use_epss, ode_method=self.ode_method)


def _clamp_duration(duration, text_ids, lens, n):
    """cfm.sample's duration rule on the host: at least max(text_len,
    ref_len) + 1, at most the bucket."""
    text_len = np.sum(np.asarray(text_ids) != -1, axis=-1)
    duration = np.maximum(np.maximum(text_len, lens) + 1, duration)
    return np.minimum(duration, n).astype(np.int32)


def draw_noise(seeds, n: int, d: int, device) -> torch.Tensor:
    """[b, n, d] fp32 N(0, 1), row i from its own generator seeded ``seeds[i]``."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        rows.append(torch.randn((n, d), generator=gen, device=device, dtype=torch.float32))
    return torch.stack(rows)


@torch.inference_mode()
def sample_and_decode(model, voc, model_cfg: ModelConfig, opts: EngineOptions, cond, text_ids,
                      lens, duration, noise, decode: bool = True):
    """cond [b, n, d] in the compute dtype -> (mel [b, n, d], int16 wav [b, T] or None)."""
    mel_out = cfm.sample(model, model_cfg.arch, cond, text_ids, duration,
                         noise.to(cond.dtype), lens=lens, opts=opts.sample_opts(),
                         backend=opts.backend)
    if not decode or voc is None:
        return mel_out, None
    b, n, _ = mel_out.shape
    dev = mel_out.device
    # roll the generated region to the front of each row; the tail gets the
    # log-mel silence floor so the vocoder's overlap-add tail stays silent
    gen_len = duration.to(dev) - lens.to(dev)
    idx = (torch.arange(n, device=dev)[None, :] + lens.to(dev).long()[:, None]) % n
    gen_mel = torch.gather(mel_out, 1, idx[..., None].expand(-1, -1, mel_out.shape[-1]))
    keep = torch.arange(n, device=dev)[None, :] < gen_len[:, None]
    floor = torch.full((), SILENCE_FLOOR, dtype=gen_mel.dtype, device=dev)
    gen_mel = torch.where(keep[..., None], gen_mel, floor).float()
    wav = vocos.decode(voc, gen_mel, lens=gen_len)
    wav_i16 = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)  # truncates like JAX
    return mel_out, wav_i16


@torch.inference_mode()
def sample_and_decode_from_wav(model, voc, model_cfg: ModelConfig, opts: EngineOptions, wav_i16,
                               wav_scale, lens, text_ids, duration, noise, n: int,
                               decode: bool = True):
    """Ref-audio mel extraction + sampling + vocoder.  ``wav_i16`` [b, S] is
    the host-reflect-padded ref wav at a ref-length bucket, ``wav_scale`` [b]
    its dequantization scale; ``noise`` [b, n, d]."""
    wav = wav_i16.float() * (wav_scale[:, None] / 32767.0)
    mel = log_mel_prepadded(wav, model_cfg.mel)  # [b, m_ref, d]
    m_ref = mel.shape[1]
    mel = torch.nn.functional.pad(mel, (0, 0, 0, n - m_ref)) if m_ref < n else mel[:, :n]
    valid = torch.arange(n, device=mel.device)[None, :, None] < lens[:, None, None]
    cond = torch.where(valid, mel, torch.zeros_like(mel))
    compute_dtype = next(model.parameters()).dtype
    return sample_and_decode(model, voc, model_cfg, opts, cond.to(compute_dtype), text_ids, lens,
                             duration, noise, decode=decode)


def _ref_mel_bucket_pad(wav: np.ndarray, mel_cfg: MelConfig, S: int) -> np.ndarray:
    padded = np.pad(np.asarray(wav, np.float32), stft_pad_amount(mel_cfg), mode="reflect")
    return np.pad(padded, (0, max(0, S - len(padded))))[:S]


class InferenceEngine:
    """Holds the DiT (``CFM.transformer``) and vocoder on one device; exposes
    batch mel / waveform generation."""

    def __init__(self, model, model_cfg: ModelConfig, vocoder=None, dtype=torch.float32,
                 buckets=DEFAULT_BUCKETS, options: EngineOptions = EngineOptions()):
        self.model_cfg = model_cfg
        self.dtype = dtype
        self.buckets = buckets
        self.options = options
        self.model = model.to(dtype=dtype).eval()
        self.device = next(self.model.parameters()).device
        fuse_for_inference(self.model.transformer)
        self.vocoder = None if vocoder is None else vocoder.to(self.device, torch.float32).eval()
        self.hop = model_cfg.mel.hop_length
        # exact-bytes cache of device-resident int16 ref uploads (see _ref_wav_device)
        self._ref_dev_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()

    def _ref_wav_device(self, wav_i16: np.ndarray, b: int, S: int) -> torch.Tensor:
        """LRU of the broadcast int16 ref upload, keyed by exact bytes:
        streaming and repeated requests reuse one reference across calls."""
        key = (wav_i16.tobytes(), b, S)
        dev = self._ref_dev_cache.pop(key, None)
        if dev is None:
            host = np.broadcast_to(wav_i16, (b, S)).copy()
            dev = torch.from_numpy(host).to(self.device)
        self._ref_dev_cache[key] = dev
        while len(self._ref_dev_cache) > 8:
            self._ref_dev_cache.popitem(last=False)
        return dev

    def _seeds(self, seeds, b):
        return list(np.random.randint(0, 2**31 - 1, size=b)) if seeds is None else seeds

    def _trim_wavs(self, wav, duration, lens):
        """Dequantize the int16 waveform and cut each row to its generated
        length ((frames - 1) * hop samples for Vocos).  The generated region
        sits at the front of each row, so the device array is first cropped
        to the batch's longest row (rounded up to 128 frames) before the copy
        to the host."""
        gen_frames = [int(d - ln) for d, ln in zip(duration, lens)]
        wavs = []
        if wav is not None:
            if gen_frames:
                crop_f = -(-max(max(gen_frames), 1) // 128) * 128
                wav = wav[:, : min(crop_f * self.hop, wav.shape[1])]
            wav_np = wav.cpu().numpy().astype(np.float32) / 32767.0
            for i, gf in enumerate(gen_frames):
                wavs.append(wav_np[i, : max(gf - 1, 0) * self.hop])
        return wavs, gen_frames

    def ref_mel(self, wav: np.ndarray) -> np.ndarray:
        """Reference-audio log-mel [n_ref, d] (center=True parity through a
        host reflect-pad and bucketed frames)."""
        mel_cfg = self.model_cfg.mel
        n_ref = num_frames(len(wav), mel_cfg)
        S = pick_bucket(n_ref, self.buckets) * self.hop + mel_cfg.n_fft
        padded = _ref_mel_bucket_pad(wav, mel_cfg, S)
        with torch.inference_mode():
            mel = log_mel_prepadded(torch.from_numpy(padded[None]).to(self.device), mel_cfg)
        return mel[0, :n_ref].cpu().numpy()

    def _text_matrix(self, text_ids_list, n):
        text_ids = np.full((len(text_ids_list), n), -1, np.int32)
        for i, t in enumerate(text_ids_list):
            text_ids[i, : min(len(t), n)] = t[:n]
        return text_ids

    def _to_dev(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def generate_batch(self, ref_mels, text_ids_list, durations, seeds=None, decode=True,
                       fetch_mel=True):
        """Mel-conditioned generation -> (mels [b, n, d] fp32 | None, wavs, gen_frames)."""
        b = len(ref_mels)
        d = self.model_cfg.mel.n_mel_channels
        n = pick_bucket(max(durations), self.buckets)
        cond = np.zeros((b, n, d), np.float32)
        lens = np.zeros((b,), np.int32)
        for i, m in enumerate(ref_mels):
            cond[i, : len(m)] = m
            lens[i] = len(m)
        text_ids = self._text_matrix(text_ids_list, n)
        duration = _clamp_duration(np.asarray(durations, np.int32), text_ids, lens, n)
        noise = draw_noise(self._seeds(seeds, b), n, d, self.device)
        mel_out, wav = sample_and_decode(
            self.model.transformer, self.vocoder, self.model_cfg, self.options,
            self._to_dev(cond).to(self.dtype), self._to_dev(text_ids), self._to_dev(lens),
            self._to_dev(duration), noise, decode=decode and self.vocoder is not None)
        mel_np = mel_out.float().cpu().numpy() if fetch_mel else None
        wavs, gen_frames = self._trim_wavs(wav, duration, lens)
        return mel_np, wavs, gen_frames

    def generate_batch_from_wavs(self, ref_wavs, text_ids_list, durations, seeds=None,
                                 decode=True, fetch_mel=True):
        """Generation from per-row reference waveforms, mel extraction on the
        device; rows ship int16 at the ref-length bucket of the longest ref."""
        b = len(ref_wavs)
        mel_cfg = self.model_cfg.mel
        n = pick_bucket(max(durations), self.buckets)
        ref_frames = [len(w) // self.hop for w in ref_wavs]
        S = pick_bucket(min(max(ref_frames) + 1, n), self.buckets) * self.hop + mel_cfg.n_fft
        shared = all(w is ref_wavs[0] for w in ref_wavs)
        wavs_i16 = np.zeros((b, S), np.int16)
        scales = np.zeros((b,), np.float32)
        for i, w in enumerate(ref_wavs[:1] if shared else ref_wavs):
            padded = _ref_mel_bucket_pad(w, mel_cfg, S)
            scale = max(max(float(np.abs(padded).max()), 1e-6), 1.0)  # normalize only if clipping
            wavs_i16[i] = np.round(padded / scale * 32767.0).astype(np.int16)
            scales[i] = scale
        if shared:
            wav_dev = self._ref_wav_device(wavs_i16[0], b, S)
            scales[:] = scales[0]
        else:
            wav_dev = self._to_dev(wavs_i16)
        lens = np.asarray([min(rf, n) for rf in ref_frames], np.int32)
        text_ids = self._text_matrix(text_ids_list, n)
        duration = _clamp_duration(np.asarray(durations, np.int32), text_ids, lens, n)
        noise = draw_noise(self._seeds(seeds, b), n, mel_cfg.n_mel_channels, self.device)
        mel_out, wav = sample_and_decode_from_wav(
            self.model.transformer, self.vocoder, self.model_cfg, self.options, wav_dev,
            self._to_dev(scales), self._to_dev(lens), self._to_dev(text_ids),
            self._to_dev(duration), noise, n, decode=decode and self.vocoder is not None)
        mel_np = mel_out.float().cpu().numpy() if fetch_mel else None
        wavs, gen_frames = self._trim_wavs(wav, duration, lens)
        return mel_np, wavs, gen_frames

    def generate_batch_from_wav(self, ref_wav, text_ids_list, durations, seeds=None, decode=True,
                                fetch_mel=True):
        """One reference waveform shared by every row (the chunks of one
        utterance): its int16 upload is cached by exact bytes."""
        return self.generate_batch_from_wavs([ref_wav] * len(text_ids_list), text_ids_list,
                                             durations, seeds=seeds, decode=decode,
                                             fetch_mel=fetch_mel)
