"""Parallelism: process start-up, device meshes, data-parallel and ZeRO-1
training, sequence parallelism on ring attention, tensor parallelism and the
GPipe pipeline.

JAX counterpart: ``f5_tts_tpu/parallel/``.  JAX runs one controller per host
and lets GSPMD place the arrays; the port runs one process per GPU
(``torchrun``) and every collective is explicit: ``tensor.py`` (Megatron's
operators over ``model``), ``pipeline.py`` (the stages over ``pipe``),
``layout.py`` (where each parameter of a model lies over a mesh).
"""
