"""Precise epochs <-> updates arithmetic, counting the residual batch
(reference scripts/count_max_epoch_precise.py).

JAX counterpart: ``scripts/count_max_epoch_precise.py``: the number of
packed batches comes from the port's ``train/dataset.py``
``DynamicBatchSampler`` over the durations of ``<dataset_dir>/duration.json``
instead of the frames ratio.  Host arithmetic only.

    python -m f5_tts_tpu_torch.scripts.count_max_epoch_precise --dataset_dir DIR
"""

from __future__ import annotations

import argparse
import json


class _Durations:
    """The sampler's view of a dataset: its length and each row's frames."""

    def __init__(self, durs):
        self.durs = durs

    def __len__(self):
        return len(self.durs)

    def get_frame_len(self, i):
        return self.durs[i] * 24000 / 256


def main(argv=None) -> tuple[float, float]:
    p = argparse.ArgumentParser(prog="count_max_epoch_precise")
    p.add_argument("--dataset_dir", required=True, help="dir with duration.json")
    p.add_argument("--frames_per_device", type=int, default=38_400)
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--num_devices", type=int, default=8)
    p.add_argument("--wanted_updates", type=int, default=1_250_000)
    args = p.parse_args(argv)

    with open(f"{args.dataset_dir}/duration.json") as f:
        durations = json.load(f)["duration"]

    from f5_tts_tpu_torch.train.dataset import DynamicBatchSampler

    sampler = DynamicBatchSampler(_Durations(durations), args.frames_per_device, args.max_samples)
    per_epoch = len(sampler) / args.num_devices
    epochs = args.wanted_updates / per_epoch
    print(f"batches per epoch per device: {per_epoch:.0f}")
    print(f"epochs for {args.wanted_updates} updates: {epochs:.2f}")
    return per_epoch, epochs


if __name__ == "__main__":
    main()
