"""Silence detection / splitting — numpy replacement for the pydub ops the
reference uses (src/f5_tts/infer/utils_infer.py:279-348,596-618).

Operates on float32 waveforms at millisecond granularity.  dBFS follows pydub:
20*log10(rms / full_scale), -inf for digital silence.
"""

from __future__ import annotations

import numpy as np


def _dbfs(wav: np.ndarray) -> float:
    r = np.sqrt(np.mean(np.square(wav))) if wav.size else 0.0
    return 20.0 * np.log10(r) if r > 0 else -float("inf")


def _ms(n_samples: int, sr: int) -> int:
    return int(n_samples * 1000 / sr)


def _samp(ms: float, sr: int) -> int:
    return int(ms * sr / 1000)


def detect_leading_silence(wav: np.ndarray, sr: int, silence_threshold: float = -42.0, chunk_ms: int = 10) -> int:
    """Returns number of leading silent SAMPLES (pydub returns ms)."""
    step = _samp(chunk_ms, sr)
    pos = 0
    while pos + step <= len(wav):
        if _dbfs(wav[pos : pos + step]) > silence_threshold:
            break
        pos += step
    return min(pos, len(wav))


def detect_silence(
    wav: np.ndarray, sr: int, min_silence_len: int = 1000, silence_thresh: float = -50.0, seek_step: int = 10
) -> list[tuple[int, int]]:
    """Silent ranges in ms, pydub-compatible sliding-window scan."""
    seg_len = _ms(len(wav), sr)
    if seg_len < min_silence_len:
        return []
    starts = []
    last_start = seg_len - min_silence_len
    for start in range(0, last_start + 1, seek_step):
        s, e = _samp(start, sr), _samp(start + min_silence_len, sr)
        if _dbfs(wav[s:e]) <= silence_thresh:
            starts.append(start)
    if not starts:
        return []
    # merge overlapping windows
    ranges = []
    cur_s, cur_e = starts[0], starts[0] + min_silence_len
    for st in starts[1:]:
        if st <= cur_e:
            cur_e = st + min_silence_len
        else:
            ranges.append((cur_s, cur_e))
            cur_s, cur_e = st, st + min_silence_len
    ranges.append((cur_s, cur_e))
    return ranges


def split_on_silence(
    wav: np.ndarray,
    sr: int,
    min_silence_len: int = 1000,
    silence_thresh: float = -50.0,
    keep_silence: int = 1000,
    seek_step: int = 10,
) -> list[np.ndarray]:
    """Non-silent chunks with ``keep_silence`` ms of padding kept on each side
    (pydub.silence.split_on_silence semantics)."""
    silent = detect_silence(wav, sr, min_silence_len, silence_thresh, seek_step)
    seg_len = _ms(len(wav), sr)
    if not silent:
        return [wav.copy()] if len(wav) else []
    # non-silent ranges = complement
    ranges = []
    prev_end = 0
    for s, e in silent:
        if s > prev_end:
            ranges.append((prev_end, s))
        prev_end = e
    if prev_end < seg_len:
        ranges.append((prev_end, seg_len))
    if not ranges:
        return []
    out = []
    for s, e in ranges:
        s2 = max(0, s - keep_silence)
        e2 = min(seg_len, e + keep_silence)
        out.append(wav[_samp(s2, sr) : _samp(e2, sr)].copy())
    return out


def remove_silence_edges(wav: np.ndarray, sr: int, silence_threshold: float = -42.0) -> np.ndarray:
    """Trim leading/trailing silence (reference utils_infer.py:277-293)."""
    start = detect_leading_silence(wav, sr, silence_threshold)
    wav = wav[start:]
    end = detect_leading_silence(wav[::-1], sr, silence_threshold)
    return wav[: len(wav) - end] if end > 0 else wav
