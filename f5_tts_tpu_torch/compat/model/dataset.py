"""Alias of ``f5_tts.model.dataset`` (reference src/f5_tts/model/dataset.py)."""

from f5_tts_tpu_torch.train.dataset import (  # noqa: F401
    CustomDataset,
    DynamicBatchSampler,
    HFDataset,
    collate_batch as collate_fn,
    load_dataset,
)
