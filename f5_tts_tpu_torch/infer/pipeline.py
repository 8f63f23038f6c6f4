"""Shared inference pipeline (reference src/f5_tts/infer/utils_infer.py:384-593).

JAX counterpart: ``f5_tts_tpu/infer/pipeline.py``, copied with the imports
pointed at the port.  All text chunks of an utterance share the reference
audio, so they run as one batch through the engine; cross-fade stitching
runs on the host.  The streaming path generates chunk by chunk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from f5_tts_tpu_torch.audio.io import resample, rms
from f5_tts_tpu_torch.infer.engine import InferenceEngine
from f5_tts_tpu_torch.text.chunk import chunk_text
from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5_tts_tpu_torch.text.tokenizer import tokens_to_ids

# module-level defaults = reference utils_infer.py:52-65
TARGET_RMS = 0.1
CROSS_FADE_DURATION = 0.15
NFE_STEP = 32
CFG_STRENGTH = 2.0
SWAY_SAMPLING_COEF = -1.0
SPEED = 1.0
FIX_DURATION = None


@dataclass
class PipelineOptions:
    target_rms: float = TARGET_RMS
    cross_fade_duration: float = CROSS_FADE_DURATION
    speed: float = SPEED
    fix_duration: float | None = FIX_DURATION
    seed: int | None = None


def text_to_ids(texts: list[str], vocab, tokenizer: str = "pinyin") -> np.ndarray:
    """Tokenize per the model's tokenizer type (reference cfm.py:119-124)."""
    if tokenizer == "pinyin":
        token_lists = convert_char_to_pinyin(texts)
        return tokens_to_ids(token_lists, vocab)
    if tokenizer == "char":
        return tokens_to_ids([list(t) for t in texts], vocab)
    if tokenizer == "byte":
        return tokens_to_ids(texts, None)
    raise ValueError(f"unknown tokenizer {tokenizer}")


def estimate_durations(
    ref_frames: int, ref_text: str, gen_texts: list[str], speed: float, fix_duration: float | None,
    sample_rate: int, hop: int,
) -> list[int]:
    """Byte-ratio duration estimate (reference utils_infer.py:479-493)."""
    out = []
    ref_bytes = max(len(ref_text.encode("utf-8")), 1)
    for gen_text in gen_texts:
        local_speed = speed if len(gen_text.encode("utf-8")) >= 10 else 0.3
        if fix_duration is not None:
            out.append(int(fix_duration * sample_rate / hop))
        else:
            gen_bytes = len(gen_text.encode("utf-8"))
            out.append(ref_frames + int(ref_frames / ref_bytes * gen_bytes / local_speed))
    return out


def cross_fade_stitch(waves: list[np.ndarray], cross_fade_duration: float, sample_rate: int) -> np.ndarray:
    """Linear cross-fade concatenation (reference utils_infer.py:553-585)."""
    if not waves:
        return np.zeros(0, np.float32)
    if cross_fade_duration <= 0:
        return np.concatenate(waves)
    final = waves[0]
    for nxt in waves[1:]:
        cf = int(cross_fade_duration * sample_rate)
        cf = min(cf, len(final), len(nxt))
        if cf <= 0:
            final = np.concatenate([final, nxt])
            continue
        fade_out = np.linspace(1, 0, cf, dtype=np.float32)
        fade_in = np.linspace(0, 1, cf, dtype=np.float32)
        overlap = final[-cf:] * fade_out + nxt[:cf] * fade_in
        final = np.concatenate([final[:-cf], overlap, nxt[cf:]])
    return final


def infer_batch_process(
    engine: InferenceEngine,
    ref_audio: tuple[np.ndarray, int],
    ref_text: str,
    gen_text_batches: list[str],
    vocab,
    tokenizer: str = "pinyin",
    opts: PipelineOptions = PipelineOptions(),
    streaming: bool = False,
    chunk_size: int = 2048,
):
    """Returns (final_wave, sample_rate, combined_mel) or, when streaming,
    yields (chunk, sample_rate) pieces (reference utils_infer.py:440-593)."""
    wav, sr = ref_audio
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=0)
    audio_rms = rms(wav)
    target_rms = opts.target_rms
    if 0 < audio_rms < target_rms:
        wav = wav * (target_rms / audio_rms)
    mel_cfg = engine.model_cfg.mel
    sr_t = mel_cfg.target_sample_rate
    if sr != sr_t:
        wav = resample(wav, sr, sr_t)

    if ref_text and len(ref_text[-1].encode("utf-8")) == 1:
        ref_text = ref_text + " "

    ref_frames = len(wav) // mel_cfg.hop_length  # reference uses audio len // hop

    texts = [ref_text + g for g in gen_text_batches]
    ids = text_to_ids(texts, vocab, tokenizer)
    durations = estimate_durations(
        ref_frames, ref_text, gen_text_batches, opts.speed, opts.fix_duration, sr_t, mel_cfg.hop_length
    )
    seeds = None if opts.seed is None else [opts.seed] * len(texts)
    ids_list = [ids[i][ids[i] != -1] for i in range(len(texts))]

    _no_vocoder_msg = (
        "the engine has no vocoder weights (mel-only mode), so no waveform"
        " was decoded — pass vocoder_local_path (or init_random for smoke"
        " tests) when constructing the model"
    )

    if streaming:
        # per-chunk generation so audio starts flowing after the FIRST chunk
        # finishes (the reference yields chunk-by-chunk, utils_infer.py:528-538;
        # one batched graph over all chunks would hold TTFB hostage to the
        # whole utterance).  A 1-worker executor generates chunk i+1 while
        # chunk i streams.
        from concurrent.futures import ThreadPoolExecutor

        def run_chunk(i):
            _, ws, gfs = engine.generate_batch_from_wav(
                wav, [ids_list[i]], [durations[i]],
                seeds=None if seeds is None else [seeds[i]], fetch_mel=False,
            )
            if not ws and any(gf > 0 for gf in gfs):
                raise RuntimeError(_no_vocoder_msg)
            return ws

        def gen():
            ex = ThreadPoolExecutor(max_workers=1)
            try:
                futs = [ex.submit(run_chunk, i) for i in range(len(texts))]
                for f in futs:
                    for w in f.result():
                        if 0 < audio_rms < target_rms:
                            w = w * (audio_rms / target_rms)
                        for j in range(0, len(w), chunk_size):
                            yield w[j : j + chunk_size], sr_t
            finally:
                # cancel queued chunks too: a consumer that abandons the
                # stream early (client disconnect) must not keep the device
                # busy synthesizing audio nobody will read
                ex.shutdown(wait=False, cancel_futures=True)

        return gen()

    # fused path: ref-mel extraction runs on the device inside the same call
    mels, wavs, gen_frames = engine.generate_batch_from_wav(
        wav, ids_list, durations, seeds=seeds, fetch_mel=True,
    )
    if not wavs and any(g > 0 for g in gen_frames):
        raise RuntimeError(_no_vocoder_msg)
    if 0 < audio_rms < target_rms:
        wavs = [w * (audio_rms / target_rms) for w in wavs]

    final = cross_fade_stitch(wavs, opts.cross_fade_duration, sr_t)
    # combined generated-region mel, [d, n] layout like the reference
    specs = [mels[i, ref_frames : ref_frames + gen_frames[i]].T for i in range(len(texts))]
    combined = np.concatenate(specs, axis=1) if specs else None
    return final, sr_t, combined


def infer_process(
    engine: InferenceEngine,
    ref_audio: tuple[np.ndarray, int],
    ref_text: str,
    gen_text: str,
    vocab,
    tokenizer: str = "pinyin",
    opts: PipelineOptions = PipelineOptions(),
    show_info=print,
):
    """Chunk long text by the ref speech rate, then batch-generate
    (reference utils_infer.py:384-434)."""
    wav, sr = ref_audio
    ref_dur = len(wav) / sr
    max_chars = int(len(ref_text.encode("utf-8")) / max(ref_dur, 1e-6) * (22 - ref_dur) * opts.speed)
    gen_text_batches = chunk_text(gen_text, max_chars=max(max_chars, 1))
    for i, batch_text in enumerate(gen_text_batches):
        show_info(f"gen_text {i}: {batch_text}")
    if not gen_text_batches:
        return None, engine.model_cfg.mel.target_sample_rate, None
    show_info(f"Generating audio in {len(gen_text_batches)} batches...")
    return infer_batch_process(
        engine, (wav, sr), ref_text, gen_text_batches, vocab, tokenizer=tokenizer, opts=opts
    )
