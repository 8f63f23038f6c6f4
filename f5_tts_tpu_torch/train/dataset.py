"""Training datasets and frame-budget dynamic batching.

JAX counterpart: ``f5_tts_tpu/train/dataset.py`` (``CustomDataset`` :24-130
with ``wav_batch`` :85-130, ``HFDataset`` :132-159,
``DynamicBatchSampler`` :162-211, ``SampleBatchSampler`` :214-237,
``pad_frames_to`` and ``collate_batch`` :240-269, ``collate_wav_batch``
:272-312, ``load_dataset`` :315-343).  Rows are {audio_path, text,
duration [s]} (mel computed on the host by ``ops/mel.log_mel_np``) or
{mel_spec, text} (``preprocessed_mel``); ``HFDataset`` takes any row source
with in-row audio.  The sampler sorts by frame length, packs greedily under
the frame budget and shuffles the batch list with seed + epoch.  Every
batch is padded to a multiple of 256 frames.  For ``mel_in_graph`` the host
only decodes and pads (``wav_batch``, ``collate_wav_batch``) and the train
step takes the mel on the device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from f5_tts_tpu_torch.audio.io import load_wav, resample
from f5_tts_tpu_torch.audio.native_loader import load_batch, native_available
from f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_np, num_frames, stft_pad_amount


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

    def wav_batch(self, indices) -> list[dict]:
        """The raw audio of a batch for the in-graph mel path:
        ``[{"wav": float32 [S_i], "text": str}, ...]`` at the target rate,
        through the native threaded batch decoder when it is built, else row
        by row (JAX ``wav_batch``)."""
        if self.preprocessed_mel:
            raise ValueError("wav_batch (Trainer(mel_in_graph=True)) needs raw-audio rows with "
                             "'audio_path'; this dataset has preprocessed 'mel_spec' rows: use "
                             "the default host-mel pipeline instead")
        rows = [self.data[self._probe(i)] for i in indices]
        sr_t = self.mel_cfg.target_sample_rate
        if native_available():
            # the decode cap follows the duration filter (a widened filter is not truncated)
            cap = float(self.duration_filter[1]) + 5.0
            max_s = min(max(float(r["duration"]) for r in rows) + 0.5, cap)
            wavs, lens = load_batch([r["audio_path"] for r in rows], sr_t, max_seconds=max_s)
            if all(int(n) >= 0 for n in lens):
                return [{"wav": wavs[i, :int(lens[i])], "text": r["text"]}
                        for i, r in enumerate(rows)]
        out = []
        for r in rows:
            wav, sr = load_wav(r["audio_path"])
            if sr != sr_t:
                wav = resample(wav, sr, sr_t)
            out.append({"wav": np.asarray(wav, np.float32), "text": r["text"]})
        return out


class HFDataset:
    """Rows with in-row audio (reference dataset.py:17-79, JAX ``HFDataset``):
    ``{"audio": {"array", "sampling_rate"}, "text"}`` (or ``"transcript"``),
    from any indexable row source (a HuggingFace dataset, a list of dicts);
    the mel is computed on the host per item."""

    def __init__(self, hf_dataset, mel_cfg: MelConfig = MelConfig()):
        self.data = hf_dataset
        self.mel_cfg = mel_cfg

    def get_frame_len(self, index: int) -> float:
        audio = self.data[index]["audio"]
        return (len(audio["array"]) / audio["sampling_rate"] * self.mel_cfg.target_sample_rate
                / self.mel_cfg.hop_length)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        row = self.data[index]
        audio = row["audio"]
        wav = np.asarray(audio["array"], dtype=np.float32)
        sr = int(audio["sampling_rate"])
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if sr != self.mel_cfg.target_sample_rate:
            wav = resample(wav, sr, self.mel_cfg.target_sample_rate)
        mel = log_mel_np(wav, self.mel_cfg)[0]
        return {"mel": mel, "text": row.get("text") or row.get("transcript", "")}


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
    return {"mel": mel, "text_ids": _pad_ids(ids, text_len), "lens": lens}


def _pad_ids(ids: np.ndarray, text_len: int | None) -> np.ndarray:
    """-1 pad (or cut) the token ids to ``text_len``, default a 64-multiple."""
    nt = text_len if text_len is not None else pad_frames_to(ids.shape[1], 64)
    if ids.shape[1] < nt:
        return np.pad(ids, ((0, 0), (0, nt - ids.shape[1])), constant_values=-1)
    return ids[:, :nt]


def collate_wav_batch(items: list[dict], vocab, tokenizer: str, mel_cfg: MelConfig,
                      frame_multiple: int = 256, mel_len: int | None = None,
                      text_len: int | None = None) -> dict:
    """Wav-in collate for the in-graph mel path: the host only reflect-pads
    and buckets the waveforms; the train step takes the log-mel on the
    device.  Returns numpy {"wav" [b, S] int16, "wav_scale" [b] fp32,
    "text_ids" [b, nt], "lens" [b]}, with S = (n - 1) * hop + n_fft so that
    ``log_mel_prepadded`` yields exactly n frames, and ``lens`` as the mel
    collate gives them.  Each row ships as int16 with its scale (half the
    bytes of an fp32 waveform, 1.28x those of the fp32 100-bin mel;
    requantization error ~3e-5 of full scale)."""
    from f5_tts_tpu_torch.infer.pipeline import text_to_ids

    hop = mel_cfg.hop_length
    frames = np.asarray([num_frames(len(it["wav"]), mel_cfg) for it in items], np.int32)
    n = mel_len if mel_len is not None else pad_frames_to(int(frames.max()), frame_multiple)
    pad = stft_pad_amount(mel_cfg)
    S = (n - 1) * hop + mel_cfg.n_fft
    wav = np.zeros((len(items), S), np.int16)
    scale = np.ones((len(items),), np.float32)
    for i, it in enumerate(items):
        w = np.asarray(it["wav"], np.float32)
        if len(w) <= pad:  # a reflect pad needs len > pad
            w = np.pad(w, (0, pad + 1 - len(w)))
        p = np.pad(w, pad, mode="reflect")[:S]
        sc = max(float(np.abs(p).max()), 1.0)  # normalize only a row that would clip
        scale[i] = sc
        wav[i, :len(p)] = np.round(p / sc * 32767.0).astype(np.int16)
    ids = text_to_ids([it["text"] for it in items], vocab, tokenizer)
    return {"wav": wav, "wav_scale": scale, "text_ids": _pad_ids(ids, text_len),
            "lens": np.minimum(frames, n)}


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
