"""The serving runtime (JAX counterpart: ``f5_tts_tpu/runtime/``): the
offline benchmark (``benchmark``), AOT serving bundles (``aot``), and the
gRPC server and client (``grpc_server``, ``grpc_client``, ``grpc_api/``)."""
