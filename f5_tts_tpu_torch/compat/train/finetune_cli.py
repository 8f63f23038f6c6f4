"""Alias of the reference finetune CLI."""

from f5_tts_tpu_torch.train.finetune_cli import main  # noqa: F401

if __name__ == "__main__":
    main()
