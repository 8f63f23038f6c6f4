"""Seeding helpers (reference model/utils.py:19-26 ``seed_everything``).

JAX counterpart: ``f5_tts_tpu/utils/seed.py``, which seeds Python's and
numpy's generators; the port seeds torch's too (CPU and every CUDA device),
as the reference does.  The engine's noise does not depend on them: it
comes from a generator per row seeded with the request's seed."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 0) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # also seeds every CUDA device's generator
