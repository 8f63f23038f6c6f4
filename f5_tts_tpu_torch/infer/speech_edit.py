"""Speech editing (reference src/f5_tts/infer/speech_edit.py): regenerate
selected time spans of an utterance while keeping the rest frame-locked.

JAX counterpart: ``f5_tts_tpu/infer/speech_edit.py``.  Builds a frame-level
edit mask (False inside the spans to re-synthesize), feeds the original mel
as conditioning with edited spans zeroed, and samples with ``edit_mask`` so
the sampler keeps the untouched regions verbatim (reference :156-220).  Span
durations can be overridden with fix_durations (seconds), stretching or
shrinking the edited regions like the reference.  The noise comes from
numpy's ``default_rng(seed)``, as in JAX, so the two packages sample from
the same noise.  It runs eagerly on the engine's device (``cfm.sample``,
then the engine's vocoder), not through the engine's CUDA graphs.
"""

from __future__ import annotations

import numpy as np

import torch

from f5_tts_tpu_torch.audio.io import load_wav, resample, rms
from f5_tts_tpu_torch.infer.engine import pick_bucket
from f5_tts_tpu_torch.infer.pipeline import text_to_ids
from f5_tts_tpu_torch.models import bigvgan, cfm, vocos


def build_edit_masks(
    n_orig_frames: int,
    parts_to_edit: list[tuple[float, float]],  # seconds
    fix_durations: list[float] | None,
    sample_rate: int,
    hop: int,
):
    """Returns (total_frames, keep_mask [total] bool) where edited regions may
    be re-timed by fix_durations (reference speech_edit.py:156-195)."""
    keep = []
    cursor = 0
    fix = list(fix_durations) if fix_durations else None
    for start_s, end_s in parts_to_edit:
        start = int(start_s * sample_rate / hop)
        end = int(end_s * sample_rate / hop)
        keep.extend([True] * (start - cursor))
        span = (end - start) if fix is None else int(fix.pop(0) * sample_rate / hop)
        keep.extend([False] * span)
        cursor = end
    keep.extend([True] * (n_orig_frames - cursor))
    return len(keep), np.asarray(keep, dtype=bool)


def edit_speech(
    engine,
    vocab,
    tokenizer: str,
    audio_path: str,
    original_text: str,
    target_text: str,
    parts_to_edit: list[tuple[float, float]],
    fix_durations: list[float] | None = None,
    seed: int | None = None,
    target_rms: float = 0.1,
):
    """Returns (wav, sample_rate).  The edited spans are re-generated from
    ``target_text``; everything else is copied from the source."""
    mel_cfg = engine.model_cfg.mel
    sr_t = mel_cfg.target_sample_rate
    hop = mel_cfg.hop_length
    wav, sr = load_wav(audio_path)
    audio_rms = rms(wav)
    if 0 < audio_rms < target_rms:
        wav = wav * (target_rms / audio_rms)
    if sr != sr_t:
        wav = resample(wav, sr, sr_t)

    mel = engine.ref_mel(wav)  # [n_ref(+1), d]
    n_orig = len(wav) // hop
    mel = mel[:n_orig]

    total, keep_src = build_edit_masks(n_orig, parts_to_edit, fix_durations, sr_t, hop)

    # re-timed cond mel: copy kept frames from source, zeros in edit spans
    cond = np.zeros((total, mel.shape[1]), np.float32)
    cursor_src = 0
    cursor_dst = 0
    fix = list(fix_durations) if fix_durations else None
    for start_s, end_s in parts_to_edit:
        start = int(start_s * sr_t / hop)
        end = int(end_s * sr_t / hop)
        ncopy = start - cursor_src
        cond[cursor_dst : cursor_dst + ncopy] = mel[cursor_src:start]
        cursor_dst += ncopy
        span = (end - start) if fix is None else int(fix.pop(0) * sr_t / hop)
        cursor_dst += span
        cursor_src = end
    ncopy = n_orig - cursor_src
    cond[cursor_dst : cursor_dst + ncopy] = mel[cursor_src:n_orig]

    ids = text_to_ids([target_text], vocab, tokenizer)[0]
    ids = ids[ids != -1]

    n = pick_bucket(total, engine.buckets)
    cond_p = np.zeros((1, n, mel.shape[1]), np.float32)
    cond_p[0, :total] = cond
    edit_mask = np.ones((1, n), bool)
    edit_mask[0, :total] = keep_src
    text_p = np.full((1, n), -1, np.int32)
    text_p[0, : len(ids)] = ids
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((1, n, mel.shape[1])).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(engine.device)

    total_t = dev(np.array([total], np.int32))
    out = cfm.sample(
        engine.model.transformer,
        engine.model_cfg.arch,
        dev(cond_p).to(engine.dtype),
        dev(text_p),
        total_t,
        dev(noise).to(engine.dtype),
        lens=total_t,
        opts=engine.options.sample_opts(),
        edit_mask=dev(edit_mask),
        backend=engine.options.backend,
    )
    out_mel = out.float()[:, :total]
    # the engine's vocoder (JAX decodes with Vocos whatever the engine's type)
    voc_decode = bigvgan.decode if engine.vocoder_type == "bigvgan" else vocos.decode
    wav_out = voc_decode(engine.vocoder, out_mel)[0].cpu().numpy()
    if 0 < audio_rms < target_rms:
        wav_out = wav_out * (audio_rms / target_rms)
    return wav_out.astype(np.float32), sr_t
