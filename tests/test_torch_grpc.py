"""The port's gRPC surface (``f5_tts_tpu_torch/runtime/grpc_*``) on the CPU:
its server on a tiny model answers every RPC; JAX's benchmark client and
the port's both run against it (one wire format); the message module is
byte-identical to JAX's, so both load in one process and share their
message classes; ``split_data`` and ``format_report`` equal JAX's.  Every
server listens on a port the OS picks, and every call has a deadline, so
no test can hang."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import asyncio
import filecmp
import json
import os

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from f5_tts_tpu.runtime import grpc_client as JC  # noqa: E402
from f5_tts_tpu.runtime.grpc_api import f5tts_pb2 as jpb  # noqa: E402
from f5_tts_tpu_torch.runtime import grpc_client as TC  # noqa: E402
from f5_tts_tpu_torch.runtime.grpc_api import f5tts_pb2 as pb  # noqa: E402
from f5_tts_tpu_torch.runtime.grpc_api.stubs import F5TTSStub  # noqa: E402
from f5_tts_tpu_torch.runtime.grpc_server import make_server  # noqa: E402

DEADLINE = 120.0  # seconds, for each RPC and each benchmark run
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.infer.api import F5TTS

    tmp = tmp_path_factory.mktemp("grpc")
    sr = 24000
    t = np.arange(sr) / sr
    ref_path = str(tmp / "ref.wav")
    save_wav(ref_path, 0.2 * np.sin(2 * np.pi * 220 * t), sr)
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, nfe_step=2, device="cpu")
    srv, port = make_server(tts, ref_path, "a simple tone reference.", port=0,
                            host="127.0.0.1", max_batch=4, queue_delay_ms=100.0)
    srv.start()
    try:
        yield f"127.0.0.1:{port}", tts
    finally:
        srv.stop(grace=None)
        tts.engine.batcher.close()


def test_message_module_is_jax_byte_for_byte():
    for name in ("f5tts_pb2.py", "f5tts.proto"):
        assert filecmp.cmp(os.path.join(REPO, "f5_tts_tpu/runtime/grpc_api", name),
                           os.path.join(REPO, "f5_tts_tpu_torch/runtime/grpc_api", name),
                           shallow=False)
    assert pb.SynthesizeRequest is jpb.SynthesizeRequest and pb.DESCRIPTOR is jpb.DESCRIPTOR


def test_server_answers_every_rpc(server):
    addr, _ = server
    with grpc.insecure_channel(addr) as ch:
        stub = F5TTSStub(ch)
        assert stub.Health(pb.HealthRequest(), timeout=DEADLINE).status == "ok"
        req = pb.SynthesizeRequest(target_text="hello world.", seed=3, has_seed=True)
        resp = stub.Synthesize(req, timeout=DEADLINE)
        pcm = np.frombuffer(resp.waveform, dtype="<i2")
        assert resp.sample_rate == 24000 and len(pcm) > 0
        assert abs(resp.duration_s - len(pcm) / 24000) < 1e-3
        assert stub.Synthesize(req, timeout=DEADLINE).waveform == resp.waveform  # seeded
        chunks = [r.waveform for r in stub.SynthesizeStream(req, timeout=DEADLINE)]
        assert len(chunks) >= 1 and b"".join(chunks) == resp.waveform
        stats = json.loads(stub.GetStats(pb.StatsRequest(), timeout=DEADLINE).json)
        assert stats["requests"] >= 3


def test_request_supplied_reference(server, tmp_path):
    from f5_tts_tpu_torch.audio.io import save_wav

    addr, _ = server
    t = np.arange(int(24000 * 0.8)) / 24000
    other = str(tmp_path / "other.wav")
    save_wav(other, 0.15 * np.sin(2 * np.pi * 330 * t), 24000)
    with grpc.insecure_channel(addr) as ch, open(other, "rb") as f:
        resp = F5TTSStub(ch).Synthesize(pb.SynthesizeRequest(
            target_text="custom reference request.", reference_wav=f.read(),
            reference_text="another tone.", seed=1, has_seed=True), timeout=DEADLINE)
    assert len(resp.waveform) > 0


@pytest.mark.parametrize("client", [JC, TC], ids=["jax_client", "port_client"])
def test_benchmark_client_against_the_port_server(server, tmp_path, client):
    addr, _ = server
    res = asyncio.run(asyncio.wait_for(client.run_benchmark(
        addr, client.DEFAULT_PROMPTS[:6], num_tasks=3, log_dir=str(tmp_path), name="t"),
        DEADLINE))
    assert res["rtf"] > 0 and res["total_audio_s"] > 0 and res["num_prompts"] == 6
    assert res["latency_ms_p99"] >= res["latency_ms_p50"]
    assert (tmp_path / "rtf-t.txt").read_text().startswith("RTF: ")
    assert json.loads((tmp_path / "stats_summary-t.txt").read_text()) == res["server_stats"]
    assert res["server_stats"]["requests"] >= 6


@pytest.mark.parametrize("n,k", [(5, 2), (4, 4), (3, 5), (26, 4), (0, 3)])
def test_split_data_equals_jax(n, k):
    assert TC.split_data(list(range(n)), k) == JC.split_data(list(range(n)), k)


def test_format_report_and_prompts_equal_jax():
    rng = np.random.default_rng(0)
    lat = [(float(a), float(b)) for a, b in rng.uniform(0.05, 2.0, (9, 2))]
    assert TC.format_report(3.21, 17.5, lat) == JC.format_report(3.21, 17.5, lat)
    assert TC.DEFAULT_PROMPTS == JC.DEFAULT_PROMPTS


def test_server_main_refuses_the_card_it_lacks(tmp_path):
    """``--device`` defaults to the card, which this test process may lack."""
    import torch

    from f5_tts_tpu_torch.runtime import grpc_server

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would serve")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grpc_server.main(["--ref_audio", "x.wav", "--init_random", "--model", "F5TTS_Tiny",
                          "--port", "0"])
