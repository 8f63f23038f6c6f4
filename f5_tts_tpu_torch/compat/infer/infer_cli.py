"""Alias of the reference infer CLI."""

from f5_tts_tpu_torch.infer.cli import main  # noqa: F401

if __name__ == "__main__":
    main()
