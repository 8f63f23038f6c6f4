"""Generated protobuf messages + hand-written gRPC stubs for the TTS service.

The environment ships ``protoc`` and the protobuf runtime but not the
``grpc_tools`` codegen plugin, so the service stubs (normally emitted by
``protoc-gen-grpc_python``) are written by hand in ``stubs.py`` against the
protoc-generated ``f5tts_pb2`` messages — functionally identical to generated
``_pb2_grpc`` code.

JAX counterpart: ``f5_tts_tpu/runtime/grpc_api/``.  ``f5tts_pb2.py`` is
byte-identical to JAX's (proto file ``f5tts.proto``, package ``f5tts``):
protobuf's default pool then holds one set of messages that both packages
share, where differing names would collide as duplicate symbols in one
process.
"""

from f5_tts_tpu_torch.runtime.grpc_api import f5tts_pb2  # noqa: F401
