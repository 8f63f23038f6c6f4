"""The serving runtime (JAX counterpart: ``f5_tts_tpu/runtime/``): the
offline benchmark (``benchmark``) and AOT serving bundles (``aot``).  The
gRPC server and client are not ported yet (see ROADMAP.md)."""
