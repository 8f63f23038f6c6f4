"""The benchmark of the PyTorch / CUDA port (``f5_tts_tpu_torch``).

Run one cell as ``python3 -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells,
metrics and bounds are in ``BENCHMARK.json``.  Nothing here imports JAX or
the JAX package.
"""
