"""Build AOT serving bundles: a thin shim over
``f5_tts_tpu_torch.runtime.aot.main`` (JAX counterpart:
``scripts/build_engine.py``).  Run it on the card's machine:

    python -m f5_tts_tpu_torch.scripts.build_engine --out artifacts/ \
        --model F5TTS_v1_Base --ckpt model.safetensors --vocoder vocos.bin \
        --batches 1 2 --buckets 1024 --ref-buckets 512 --warm
"""

from f5_tts_tpu_torch.runtime.aot import main

if __name__ == "__main__":
    main()
