"""Training datasets and frame-budget dynamic batching.

JAX counterpart: ``f5_tts_tpu/train/dataset.py`` (``CustomDataset`` :24-83,
``DynamicBatchSampler`` :162-211, ``SampleBatchSampler`` :214-237,
``pad_frames_to`` and ``collate_batch`` :240-269, ``load_dataset``
:315-343).  Rows are {audio_path, text, duration [s]} (mel computed on the
host by ``ops/mel.log_mel_np``) or {mel_spec, text} (``preprocessed_mel``).
The sampler sorts by frame length, packs greedily under the frame budget and
shuffles the batch list with seed + epoch.  Every batch is padded to a
multiple of 256 frames.  ``HFDataset`` and the wav-in batches of
``mel_in_graph`` are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import json
import os

import numpy as np

from f5_tts_tpu_torch.audio.io import load_wav, resample
from f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_np


class CustomDataset:
    """Rows: dict(audio_path, text, duration[s]) or dict(mel_spec, text)."""

    def __init__(self, data, durations: list[float] | None = None,
                 mel_cfg: MelConfig = MelConfig(), preprocessed_mel: bool = False,
                 duration_filter=(0.3, 30.0)):
        self.data = data
        self.durations = durations
        self.mel_cfg = mel_cfg
        self.preprocessed_mel = preprocessed_mel
        self.duration_filter = duration_filter

    def get_frame_len(self, index: int) -> float:
        dur = self.durations[index] if self.durations is not None else self.data[index]["duration"]
        return dur * self.mel_cfg.target_sample_rate / self.mel_cfg.hop_length

    def __len__(self):
        return len(self.data)

    def _probe(self, index: int) -> int:
        """Duration filter (reference dataset.py:129-140): skip to the next
        row inside the window."""
        lo, hi = self.duration_filter
        while True:
            row = self.data[index]
            if self.preprocessed_mel or lo <= row["duration"] <= hi:
                return index
            index = (index + 1) % len(self.data)

    def __getitem__(self, index: int) -> dict:
        row = self.data[self._probe(index)]
        if self.preprocessed_mel:
            mel = np.asarray(row["mel_spec"], dtype=np.float32)
            if mel.shape[0] == self.mel_cfg.n_mel_channels:  # [d, n] -> [n, d]
                mel = mel.T
        else:
            wav, sr = load_wav(row["audio_path"])  # mp3 / flac through the native decoder
            if sr != self.mel_cfg.target_sample_rate:
                wav = resample(wav, sr, self.mel_cfg.target_sample_rate)
            mel = log_mel_np(wav, self.mel_cfg)[0]  # [n, d]
        return {"mel": mel, "text": row["text"]}


class DynamicBatchSampler:
    """Reference dataset.py:170-241: sort all indices by frame length, pack
    greedily under ``frames_threshold`` (and ``max_samples``), shuffle the
    BATCH list with seed + epoch."""

    def __init__(self, dataset, frames_threshold: int, max_samples: int = 0,
                 random_seed: int | None = None, drop_residual: bool = False):
        self.frames_threshold = frames_threshold
        self.max_samples = max_samples
        self.random_seed = random_seed
        self.epoch = 0
        indices = sorted(range(len(dataset)), key=lambda i: dataset.get_frame_len(i))
        batches, batch, batch_frames = [], [], 0.0
        for idx in indices:
            frame_len = dataset.get_frame_len(idx)
            if batch_frames + frame_len <= frames_threshold and (
                    max_samples == 0 or len(batch) < max_samples):
                batch.append(idx)
                batch_frames += frame_len
            else:
                if batch:
                    batches.append(batch)
                if frame_len <= frames_threshold:
                    batch, batch_frames = [idx], frame_len
                else:
                    batch, batch_frames = [], 0.0
        if not drop_residual and batch:
            batches.append(batch)
        self.batches = batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        if self.random_seed is not None:
            order = np.random.default_rng(self.random_seed + self.epoch).permutation(
                len(self.batches))
            return iter([self.batches[i] for i in order])
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class SampleBatchSampler(DynamicBatchSampler):
    """batch_size_type="sample": a fixed number of length-sorted sequences
    per batch, epoch-seeded batch shuffle."""

    def __init__(self, dataset, batch_size: int, random_seed: int | None = None,
                 drop_residual: bool = False):
        order = sorted(range(len(dataset)), key=lambda i: dataset.get_frame_len(i))
        self.batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
        if drop_residual and self.batches and len(self.batches[-1]) < batch_size:
            self.batches.pop()
        self.random_seed = random_seed
        self.epoch = 0


def pad_frames_to(n: int, multiple: int = 256) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def collate_batch(items: list[dict], vocab, tokenizer: str, frame_multiple: int = 256,
                  mel_len: int | None = None, text_len: int | None = None) -> dict:
    """Pad mels to a bucketed length and tokenize the texts -> numpy
    {"mel" [b, n, d] fp32, "text_ids" [b, nt] int32 (-1 padded), "lens" [b]}."""
    from f5_tts_tpu_torch.infer.pipeline import text_to_ids

    lens = np.asarray([it["mel"].shape[0] for it in items], np.int32)
    n = mel_len if mel_len is not None else pad_frames_to(int(lens.max()), frame_multiple)
    d = items[0]["mel"].shape[1]
    mel = np.zeros((len(items), n, d), np.float32)
    for i, it in enumerate(items):
        m = it["mel"][:n]
        mel[i, :len(m)] = m
    lens = np.minimum(lens, n)
    ids = text_to_ids([it["text"] for it in items], vocab, tokenizer)
    nt = text_len if text_len is not None else pad_frames_to(ids.shape[1], 64)
    if ids.shape[1] < nt:
        ids = np.pad(ids, ((0, 0), (0, nt - ids.shape[1])), constant_values=-1)
    else:
        ids = ids[:, :nt]
    return {"mel": mel, "text_ids": ids, "lens": lens}


def load_dataset(dataset_name: str, tokenizer: str = "pinyin",
                 dataset_type: str = "CustomDataset", audio_type: str = "raw",
                 mel_cfg: MelConfig = MelConfig(), data_root: str = "data") -> CustomDataset:
    """Reference load_dataset (dataset.py:247-307): reads
    ``<data_root>/<name>_<tokenizer>/raw.arrow`` (or ``mel.arrow``) and
    ``duration.json``.  Needs the ``datasets`` package."""
    from datasets import Dataset as ArrowDataset
    from datasets import load_from_disk

    if dataset_type == "CustomDataset":
        path = os.path.join(data_root, f"{dataset_name}_{tokenizer}")
    elif dataset_type == "CustomDatasetPath":
        path = dataset_name
    else:
        raise ValueError(f"unsupported dataset_type {dataset_type}")
    arrow = os.path.join(path, "mel.arrow" if audio_type == "mel" else "raw.arrow")
    if os.path.isfile(arrow):
        data = ArrowDataset.from_file(arrow)
    else:
        data = load_from_disk(os.path.join(path, "raw"))
    with open(os.path.join(path, "duration.json"), encoding="utf-8") as f:
        durations = json.load(f)["duration"]
    return CustomDataset(data, durations=durations, mel_cfg=mel_cfg,
                         preprocessed_mel=(audio_type == "mel"))
