"""The one traffic generator: requests and training utterances from a
mix's parameters (``benchmark/traffic/<mix>.json``) and a seed.

What a mix's cells measure must not change with the seed, so the set of
sizes (reference and generated seconds, speaking rates, utterance lengths)
comes from the mix's own ``sizes_seed`` and the run's ``--seed`` only orders
it and draws the content: the audio, the text ids and the noise seeds.

Audio is a bank of seeded voiced clips (a few harmonics of a wandering f0
under a syllable-rate envelope, with a little noise) held as int16 at 24
kHz; a request's reference and an utterance are crops of it.  Text ids are
drawn from the vocabulary, as many as the seconds times the request's
speaking rate.  A request's total frames follow the pipeline's byte-ratio
rule (``estimate_durations``, upstream ``utils_infer.py`` 487-493), one
byte per token.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

SAMPLE_RATE = 24_000
HOP = 256
VOCAB = 2545


@dataclass
class Request:
    ref_wav: np.ndarray  # float32 [L], int16 steps (k / 32767)
    text_ids: np.ndarray  # int32 [ref tokens + gen tokens]
    duration: int  # total frames by the byte-ratio rule
    gen_s: float  # the generated seconds asked for
    seed: int  # the noise seed


def estimate_duration(ref_frames: int, ref_bytes: int, gen_bytes: int, speed: float = 1.0) -> int:
    """The pipeline's byte-ratio rule (upstream ``utils_infer.py`` 487-493)."""
    local_speed = speed if gen_bytes >= 10 else 0.3
    return ref_frames + int(ref_frames / max(ref_bytes, 1) * gen_bytes / local_speed)


def audio_bank(seed: int, clips: int = 8, seconds: float = 31.0) -> np.ndarray:
    """int16 [clips, seconds * 24 kHz] voiced audio from ``seed``."""
    rng = np.random.default_rng([seed, 0xA0D10])
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    out = np.zeros((clips, n), np.int16)
    for c in range(clips):
        f0 = rng.uniform(90, 250) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.1, 0.4) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        wav = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 7))
        env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6.3))
        wav = wav * env / 2.5 + 0.01 * rng.standard_normal(n)
        out[c] = np.round(np.clip(wav * rng.uniform(0.3, 0.7), -1, 1) * 32767).astype(np.int16)
    return out


def _crop(bank: np.ndarray, rng, n: int) -> np.ndarray:
    c = int(rng.integers(bank.shape[0]))
    s = int(rng.integers(bank.shape[1] - n))
    return bank[c, s:s + n]


def _lognormal(rng, spec: dict, size: int) -> np.ndarray:
    x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size)
    return np.clip(x, *spec["clip"])


def request_sizes(mix: dict, count: int) -> list[tuple[float, float, float]]:
    """``count`` (ref seconds, gen seconds, tokens per second) from the mix's
    ``sizes_seed``, each kept to ``max_total_frames`` by the byte-ratio
    rule (a draw over it is drawn again)."""
    rng = np.random.default_rng(mix["sizes_seed"])
    out = []
    while len(out) < count:
        ref_s = float(rng.uniform(*mix["ref_s"]))
        gen_s = float(_lognormal(rng, mix["gen_s"], 1)[0])
        rate = float(rng.uniform(*mix["tokens_per_s"]))
        ref_frames = int(ref_s * SAMPLE_RATE) // HOP
        ref_tok, gen_tok = max(1, round(ref_s * rate)), max(1, round(gen_s * rate))
        if estimate_duration(ref_frames, ref_tok, gen_tok) <= mix["max_total_frames"]:
            out.append((ref_s, gen_s, rate))
    return out


def requests(mix: dict, seed: int, count: int, block: int | None = None) -> list[Request]:
    """``count`` requests: the mix's sizes in the order ``seed`` gives, with
    their audio, text ids and noise seeds drawn from ``seed``.  With a
    ``block``, the order is shuffled within each run of ``block`` requests
    only, so every seed's k-th block holds the same sizes."""
    sizes = request_sizes(mix, count)
    rng = np.random.default_rng([seed, 1])
    block = block or count
    order = np.concatenate([s + rng.permutation(min(block, count - s))
                            for s in range(0, count, block)])
    bank = audio_bank(seed)
    out = []
    for i in order:
        ref_s, gen_s, rate = sizes[i]
        n = int(ref_s * SAMPLE_RATE)
        ref_tok, gen_tok = max(1, round(ref_s * rate)), max(1, round(gen_s * rate))
        ids = rng.integers(0, VOCAB, ref_tok + gen_tok).astype(np.int32)
        dur = estimate_duration(n // HOP, ref_tok, gen_tok)
        wav = _crop(bank, rng, n).astype(np.float32) / 32767.0
        out.append(Request(wav, ids, dur, gen_s, int(rng.integers(0, 2**31 - 1))))
    return out


@dataclass
class Utterance:
    clip: int
    start: int
    samples: int
    text_ids: np.ndarray


def utterances(mix: dict, seed: int) -> tuple[np.ndarray, list[Utterance]]:
    """(the audio bank, the training pool): ``mix["pool"]`` utterances whose
    lengths come from ``sizes_seed`` and whose audio crops and text ids come
    from ``seed``."""
    lens = _lognormal(np.random.default_rng(mix["sizes_seed"]), mix["utt_s"], mix["pool"])
    rates = np.random.default_rng([mix["sizes_seed"], 1]).uniform(*mix["tokens_per_s"], mix["pool"])
    rng = np.random.default_rng([seed, 3])
    bank = audio_bank(seed, seconds=mix["utt_s"]["clip"][1] + 1.0)
    pool = []
    for i in rng.permutation(mix["pool"]):
        n = int(lens[i] * SAMPLE_RATE)
        tok = max(1, round(lens[i] * rates[i]))
        pool.append(Utterance(int(rng.integers(bank.shape[0])),
                              int(rng.integers(bank.shape[1] - n)), n,
                              rng.integers(0, VOCAB, tok).astype(np.int32)))
    return bank, pool


def utterance_wav(bank: np.ndarray, u: Utterance) -> np.ndarray:
    return bank[u.clip, u.start:u.start + u.samples]
