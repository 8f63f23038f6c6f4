"""Alias of the reference pretraining entry point."""

from f5_tts_tpu_torch.train.cli import main  # noqa: F401

if __name__ == "__main__":
    main()
