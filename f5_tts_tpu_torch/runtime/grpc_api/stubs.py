"""Hand-written gRPC service stubs for f5tts.F5TTS (the code
``protoc-gen-grpc_python`` would emit; the plugin isn't in this image).

JAX counterpart: ``f5_tts_tpu/runtime/grpc_api/stubs.py`` (a copy with the
imports changed to the port's).
"""

from __future__ import annotations

import grpc

from f5_tts_tpu_torch.runtime.grpc_api import f5tts_pb2 as pb

SERVICE_NAME = "f5tts.F5TTS"

_METHODS = {
    "Synthesize": (pb.SynthesizeRequest, pb.SynthesizeResponse, "unary_unary"),
    "SynthesizeStream": (pb.SynthesizeRequest, pb.SynthesizeResponse, "unary_stream"),
    "GetStats": (pb.StatsRequest, pb.StatsResponse, "unary_unary"),
    "Health": (pb.HealthRequest, pb.HealthResponse, "unary_unary"),
}


class F5TTSServicer:
    """Subclass and override; wired by add_f5tts_servicer."""

    def Synthesize(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Synthesize")

    def SynthesizeStream(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "SynthesizeStream")

    def GetStats(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "GetStats")

    def Health(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Health")


def add_f5tts_servicer(server: grpc.Server, servicer: F5TTSServicer) -> None:
    handlers = {}
    for name, (req_t, resp_t, kind) in _METHODS.items():
        factory = getattr(grpc, f"{kind}_rpc_method_handler")
        handlers[name] = factory(
            getattr(servicer, name),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


class F5TTSStub:
    """Client-side stub (sync channel)."""

    def __init__(self, channel: grpc.Channel):
        for name, (req_t, resp_t, kind) in _METHODS.items():
            factory = getattr(channel, kind)
            setattr(self, name, factory(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            ))


class F5TTSAioStub:
    """Client-side stub (asyncio channel) — the concurrency-sweep benchmark
    client uses this like the reference uses async tritonclient."""

    def __init__(self, channel):
        for name, (req_t, resp_t, kind) in _METHODS.items():
            factory = getattr(channel, kind)
            setattr(self, name, factory(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            ))
