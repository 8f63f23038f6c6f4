"""Command-line drivers of the port (JAX counterparts under ``scripts/``):
the W8A8 A/B ``quant_ab``, the two kernel experiments
``exp_pipelined_flash`` and ``exp_fused_ln_matmul``, the training
throughput ``bench_train``, the AOT bundle build ``build_engine`` and the
cold-start A/B ``aot_coldstart_ab``.  Run each on the card with
``python -m f5_tts_tpu_torch.scripts.<name>``."""
