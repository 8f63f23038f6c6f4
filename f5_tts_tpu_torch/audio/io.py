"""Host-side audio I/O and resampling (numpy/scipy; no torchaudio/soundfile).

WAV read/write via scipy.io.wavfile (PCM16/24/32 + float); mp3/flac via the
native C++ decoders (native/mp3dec.cpp, native/flacdec.cpp — the reference
routes these through torchaudio/ffmpeg, reference model/dataset.py:142-161);
resampling via polyphase filtering (scipy.signal.resample_poly), the same
windowed-sinc family torchaudio's Resample uses.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate).

    Dispatches by content: RIFF/WAVE through scipy, anything else (mp3,
    flac) through the native decoder library.
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:4] != b"RIFF":
        from . import native_loader

        loaded = native_loader.load_wav_mono(path)
        if loaded is None:
            raise RuntimeError(
                f"{path}: not a WAV file and the native mp3/flac decoder is "
                "unavailable (g++ build failed?)")
        return loaded
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:  # [T, C] -> mono mean (reference infer_batch_process)
        wav = wav.mean(axis=1)
    return wav, int(sr)


def save_wav(path: str, wav: np.ndarray, sample_rate: int = 24_000) -> None:
    wav = np.asarray(wav, dtype=np.float32)
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def rms(wav: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0
