"""Training input-pipeline throughput: can the host feed the card?

JAX counterpart: ``scripts/bench_input_pipeline.py``.  Writes a synthetic
on-disk WAV dataset, then measures the host-side producer rate (decode,
resample, collate) in mel frames per second over the batches of
``DynamicBatchSampler`` at 38,400 frames, through the port's
``train/dataset.py``:

  wav-path   native C++ threaded batch decode + pad only; the mel is taken
             on the card (``Trainer(mel_in_graph=True)``, ``collate_wav_batch``)
  mp3-path   the same producer over an mp3 copy of the dataset (the Emilia
             pretraining format, 64 kbps 24 kHz mono), ``native/mp3dec.cpp``
  flac-path  the same over a flac copy (``native/flacdec.cpp``)
  mel-path   per-item Python decode + numpy log-mel (``collate_batch``)

The mp3 and flac copies are encoded by the test oracles (``tests.oracles``),
as JAX's script encodes them; where those do not load, their rows are
printed as skipped.  ``--train`` then runs the full-width F5TTS_v1_Base
``Trainer(mel_in_graph=True)`` on the card, with activation checkpointing,
for two epochs of the on-disk set (the first warms the allocator, cuBLAS
and the kernels; the second, in a fresh trainer on the trained model, is
timed) and prints the second epoch's end-to-end frames/s beside the host
feed rate: the card's own consumption rate, measured here.

    python -m f5_tts_tpu_torch.scripts.bench_input_pipeline [n_files] [out_dir] [--train]
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np

SR = 24_000
FRAMES = 38_400  # DynamicBatchSampler's budget: configs/F5TTS_v1_Base.yaml per GPU


def make_rows(n_files: int, out_dir: str, dur_lo: float, dur_hi: float) -> list[dict]:
    """``n_files`` seeded 220 Hz tones in noise as WAV files (kept if present),
    with JAX's durations, texts and draws.  Each waveform is drawn, written
    or not, so the durations do not depend on which files the directory
    already holds (JAX draws the noise only for a file it writes)."""
    from f5_tts_tpu_torch.audio.io import save_wav

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_files):
        dur = float(rng.uniform(dur_lo, dur_hi))
        path = os.path.join(out_dir, f"utt_{i}.wav")
        wav = (np.sin(2 * np.pi * 220 * np.arange(int(dur * SR)) / SR)
               * 0.3 + rng.standard_normal(int(dur * SR)) * 0.05).astype(np.float32)
        if not os.path.isfile(path):
            save_wav(path, wav, SR)
        rows.append({"audio_path": path, "text": "synthetic utterance " * 3, "duration": dur})
    return rows


def compressed_copies(rows: list[dict], mel_cfg) -> list[tuple[str, object]]:
    """(format, CustomDataset) for an mp3 and a flac copy of ``rows``,
    encoded by the test oracles; empty where they do not load."""
    from f5_tts_tpu_torch.audio.io import load_wav
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    out = []
    try:
        from tests.oracles import codec_oracle
        from tests.oracles.flac_encoder import encode_flac

        for fmt in ("mp3", "flac"):
            fmt_rows = []
            for r in rows:
                path = r["audio_path"].replace(".wav", f".{fmt}")
                if not os.path.isfile(path):
                    wav, wsr = load_wav(r["audio_path"])
                    if fmt == "mp3":
                        blob = codec_oracle.lame_encode_mp3(wav, wsr, bitrate=64)
                    else:
                        ints = np.clip(wav * 32767, -32768, 32767).astype(np.int64)
                        blob = encode_flac(ints, wsr, bps=16, subframe="fixed-2")
                    with open(path, "wb") as f:
                        f.write(blob)
                fmt_rows.append({**r, "audio_path": path})
            out.append((fmt, CustomDataset(fmt_rows, durations=[r["duration"] for r in fmt_rows],
                                           mel_cfg=mel_cfg)))
    except Exception as e:  # noqa: BLE001 - oracles unavailable: the wav rows still run
        print(f"(skipping mp3/flac rows: {e})")
    return out


def collate_paths(ds, compressed, mel_cfg) -> list[tuple[str, object]]:
    """(row name, batch -> collated numpy batch) for each host path."""
    from f5_tts_tpu_torch.train.dataset import collate_batch, collate_wav_batch

    return [
        ("wav-path (C++ batch decode + pad)",
         lambda b: collate_wav_batch(ds.wav_batch(b), None, "byte", mel_cfg)),
        *((f"{fmt}-path (C++ batch decode + pad)",
           lambda b, d=ds_c: collate_wav_batch(d.wav_batch(b), None, "byte", mel_cfg))
          for fmt, ds_c in compressed),
        ("mel-path (python decode + numpy mel)",
         lambda b: collate_batch([ds[i] for i in b], None, "byte")),
    ]


def feed_rate(fn, batches) -> tuple[float, float, int]:
    """(frames/s, seconds, frames) of ``fn`` over ``batches`` after one
    warm-up call (the native library's build, imports)."""
    fn(batches[0])
    t0 = time.perf_counter()
    total = 0
    for b in batches:
        total += int(fn(b)["lens"].sum())
    dt = time.perf_counter() - t0
    return total / dt, dt, total


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    train = "--train" in argv
    pos = [a for a in argv if not a.startswith("--")]
    n_files = int(pos[0]) if pos else 64
    out_dir = pos[1] if len(pos) > 1 else os.path.join(tempfile.gettempdir(), "f5_synth_wavs")
    # --train keeps the durations near one bucket, as JAX's run does
    dur_lo, dur_hi = (9.6, 10.7) if train else (3.0, 15.0)

    from f5_tts_tpu_torch.ops.mel import MelConfig
    from f5_tts_tpu_torch.train.dataset import CustomDataset, DynamicBatchSampler

    mel_cfg = MelConfig()
    t0 = time.perf_counter()
    rows = make_rows(n_files, out_dir, dur_lo, dur_hi)
    print(f"dataset: {n_files} files, {sum(r['duration'] for r in rows):.0f} s audio "
          f"(gen {time.perf_counter()-t0:.1f}s)")
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=mel_cfg)
    batches = list(DynamicBatchSampler(ds, frames_threshold=FRAMES, max_samples=64,
                                       random_seed=0))
    print(f"{len(batches)} batches")
    rates = {}
    for name, fn in collate_paths(ds, compressed_copies(rows, mel_cfg), mel_cfg):
        rate, dt, total = feed_rate(fn, batches)
        rates[name.split(" ")[0]] = rate
        print(f"{name}: {rate:,.0f} frames/s host feed ({dt:.2f}s for {total} frames)")
    out = {"host_frames_per_s": rates}
    if train:
        e2e = train_e2e(rows, mel_cfg)
        out["train"] = e2e
        print(f"card consumption: {e2e['frames_per_s']:,.0f} frames/s end-to-end "
              f"(second epoch, F5TTS_v1_Base) against {rates['wav-path']:,.0f} frames/s "
              "host feed (wav path)")
    else:
        print("card consumption: not measured (--train runs the full-width Trainer on the card)")
    return out


def train_e2e(rows, mel_cfg, device: str = "cuda", epochs: int = 2) -> dict:
    """The full-width F5TTS_v1_Base ``Trainer(mel_in_graph=True)`` on the
    on-disk wavs, activation checkpointing on, bf16 mixed precision: one
    epoch to warm up, then one more in a fresh trainer on the trained model,
    whose wall spans only the producer and the steps.  No checkpoint is
    written (the end-of-train save of ~5 GB is not what this measures)."""
    import dataclasses

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.train.dataset import CustomDataset
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer

    model_cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    model_cfg = dataclasses.replace(
        model_cfg, arch=dataclasses.replace(model_cfg.arch, checkpoint_activations=True),
        tokenizer="byte")
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=mel_cfg)
    model = _seeded(lambda: CFM(model_cfg.arch), 0)
    walls = []
    for _ in range(epochs):
        with tempfile.TemporaryDirectory() as ck:
            tr = Trainer(model_cfg, None,
                         OptimConfig(mixed_precision=True, num_warmup_updates=10,
                                     total_updates=10_000),
                         ckpt_dir=ck, batch_size_per_device=8192, max_samples=8,
                         save_per_updates=100_000, last_per_updates=100_000, seed=0,
                         mel_in_graph=True, device=device)
            tr.save_checkpoint = lambda *a, **k: None
            if tr.device.type == "cuda":
                import torch

                torch.cuda.synchronize(tr.device)
            t0 = time.perf_counter()
            model, _, update = tr.train(model, ds, epochs=1, resume=False)
            if tr.device.type == "cuda":
                torch.cuda.synchronize(tr.device)
            walls.append(time.perf_counter() - t0)
        print(f"epoch {len(walls)}: {walls[-1]:.1f}s, {update} updates")
    real_frames = sum(math.ceil(ds.get_frame_len(i)) for i in range(len(ds)))
    rate = real_frames / walls[-1]
    print(f"steady-state epoch: {walls[-1]:.1f}s for {real_frames} real frames -> "
          f"{rate:,.0f} frames/s end-to-end")
    return {"epoch_s": walls, "real_frames": real_frames, "frames_per_s": rate,
            "updates_per_epoch": int(update)}


if __name__ == "__main__":
    main()
