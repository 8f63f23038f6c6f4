"""PyTorch / CUDA port of the F5-TTS zero-shot inference path.

Counterpart of the JAX package ``f5_tts_tpu``: each module sits at the same
relative path as its JAX counterpart and names it in its docstring.  The two
Pallas kernels of the serving path are hand-written CUDA C++ kernels for
Hopper (``csrc/``), built on first use by ``ops/cuda_build.py``.  Nothing here
imports JAX or the JAX package.
"""
