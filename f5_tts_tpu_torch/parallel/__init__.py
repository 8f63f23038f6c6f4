"""Parallelism over the data: process start-up, device meshes, data-parallel
and ZeRO-1 training, and sequence parallelism on ring attention.

JAX counterpart: ``f5_tts_tpu/parallel/``.  JAX runs one controller per host
and lets GSPMD place the arrays; the port runs one process per GPU
(``torchrun``) and every collective is explicit.  Tensor parallelism and the
GPipe pipeline (``parallel/pipeline.py``) are the next slice (ROADMAP.md).
"""
