"""Command-line drivers of the port (JAX counterparts under ``scripts/``):
the W8A8 A/B ``quant_ab``, the two kernel experiments
``exp_pipelined_flash`` and ``exp_fused_ln_matmul``, the training
throughput ``bench_train``, the AOT bundle build ``build_engine``, the
cold-start A/B ``aot_coldstart_ab``, the request profile
``profile_request``, ``count_params_gflops``, ``picard_ab``,
``parity_vs_released``, the smoke test ``smoke``, the epoch counters
``count_max_epoch`` and ``count_max_epoch_precise``, the benches
``bench_input_pipeline`` and ``bench_step_breakdown``, the probes
``train_speak_probe`` and ``train_picard_probe``, ``seeded_weights`` for
the two shell pipelines ``run_serving.sh`` and ``eval_infer_batch.sh``.
Run each with ``python -m f5_tts_tpu_torch.scripts.<name>``; they run on
the card unless asked for the CPU."""
