"""Epochs <-> updates arithmetic for frame-based batching (reference
src/f5_tts/scripts/count_max_epoch.py).

JAX counterpart: ``scripts/count_max_epoch.py``, the same numbers and the
same three lines.  Host arithmetic only.

    python -m f5_tts_tpu_torch.scripts.count_max_epoch
"""

total_hours = 95_000 / 1000  # kh -> h, Emilia ZH+EN ~95k hours
mel_hop_length = 256
mel_sampling_rate = 24_000

wanted_max_updates = 1_250_000

gpus = 8
frames_per_gpu = 38_400
grad_accum = 1

mini_batch_frames = frames_per_gpu * grad_accum * gpus
mini_batch_hours = mini_batch_frames * mel_hop_length / mel_sampling_rate / 3600
updates_per_epoch = (total_hours * 1000) / mini_batch_hours
steps_per_epoch = updates_per_epoch * grad_accum


def main() -> None:
    print(f"  mini-batch size: {mini_batch_frames} frames = {mini_batch_hours:.2f} hours / mini-batch")
    print(f"  updates per epoch: {updates_per_epoch:.0f}")
    print(f"  max epochs for {wanted_max_updates} updates: {wanted_max_updates / updates_per_epoch:.2f}")


if __name__ == "__main__":
    main()
