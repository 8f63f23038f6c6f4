"""Concurrent gRPC benchmark client — the reference client_grpc.py
counterpart (runtime/triton_trtllm/client_grpc.py:292-303 async tasks,
:425-447 latency percentiles + server-stats report).

Splits a prompt set over ``--num-tasks`` asyncio tasks, each sending unary
Synthesize RPCs back-to-back; reports RTF = total wall / total generated
audio, per-utterance latency mean/variance/p50/90/95/99, writes the
reference-format ``rtf-{name}.txt``, and appends the server's dynamic-batcher
stats (the Triton inference-statistics analog).

    python -m f5_tts_tpu_torch.runtime.grpc_client --server localhost:50051 \
        --num-tasks 4 --num-prompts 26

JAX counterpart: ``f5_tts_tpu/runtime/grpc_client.py`` (a copy with the
imports changed to the port's; the wire format is the same, so either
client talks to either server).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

import numpy as np

from f5_tts_tpu_torch.runtime.grpc_api import f5tts_pb2 as pb
from f5_tts_tpu_torch.runtime.grpc_api.stubs import F5TTSAioStub

# 26 target texts in the spirit of the reference's wenetspeech4tts hardcoded
# split (client_grpc.py --split-name): varied lengths, plain English so the
# default char/pinyin tokenizers both handle them.
DEFAULT_PROMPTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello there, how are you doing today?",
    "Synthesis of natural speech remains a fascinating challenge.",
    "Please arrive ten minutes before the meeting starts.",
    "Rain is expected across the northern valleys tonight.",
    "She sells seashells by the seashore every summer.",
    "A journey of a thousand miles begins with a single step.",
    "The committee will announce its decision on Friday afternoon.",
    "Fresh coffee and warm bread make the morning better.",
    "Turn left at the second traffic light and continue straight.",
    "Our flight departs at seven forty five in the evening.",
    "The library closes early on public holidays.",
    "He finished the marathon in just under four hours.",
    "Remember to water the plants while we are away.",
    "The orchestra rehearsed the symphony one final time.",
    "Quiet reflection often leads to the clearest answers.",
    "The bridge spans nearly two kilometers across the bay.",
    "Children laughed as the kites climbed into the wind.",
    "This recipe calls for two cups of flour and one egg.",
    "The museum's new exhibit opens to the public next week.",
    "Engineers tested the turbine under extreme conditions.",
    "A gentle breeze carried the scent of blooming jasmine.",
    "The train to the coast leaves from platform nine.",
    "Historians still debate the causes of the conflict.",
    "Set the oven to one hundred eighty degrees and wait.",
    "Tomorrow brings another chance to get things right.",
]


def split_data(items, k):
    """Contiguous split, same as reference client_grpc.py:split_data."""
    n = len(items)
    base, rem = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append(items[start : start + size])
        start += size
    return [chunk for chunk in out if chunk]


async def _task(stub, prompts, task_id, ref_wav_bytes, ref_text, seed_base):
    total_audio = 0.0
    latency_data = []
    for i, text in enumerate(prompts):
        req = pb.SynthesizeRequest(
            target_text=text,
            reference_text=ref_text or "",
            reference_wav=ref_wav_bytes or b"",
            seed=seed_base + task_id * 1000 + i,
            has_seed=True,
        )
        t0 = time.time()
        resp = await stub.Synthesize(req)
        dt = time.time() - t0
        dur = len(resp.waveform) // 2 / max(resp.sample_rate, 1)
        total_audio += dur
        latency_data.append((dt, dur))
    return total_audio, latency_data


def format_report(elapsed, total_audio, latency_data) -> str:
    """Reference rtf-*.txt format (client_grpc.py:425-441)."""
    rtf = elapsed / max(total_audio, 1e-9)
    lat = [l for (l, _d) in latency_data]
    s = f"RTF: {rtf:.4f}\n"
    s += f"total_duration: {total_audio:.3f} seconds\n"
    s += f"({total_audio / 3600:.2f} hours)\n"
    s += f"processing time: {elapsed:.3f} seconds ({elapsed / 3600:.2f} hours)\n"
    s += f"latency_variance: {np.var(lat, dtype=np.float64) * 1000.0:.2f}\n"
    s += f"latency_50_percentile_ms: {np.percentile(lat, 50) * 1000.0:.2f}\n"
    s += f"latency_90_percentile_ms: {np.percentile(lat, 90) * 1000.0:.2f}\n"
    s += f"latency_95_percentile_ms: {np.percentile(lat, 95) * 1000.0:.2f}\n"
    s += f"latency_99_percentile_ms: {np.percentile(lat, 99) * 1000.0:.2f}\n"
    s += f"average_latency_ms: {sum(lat) / len(lat) * 1000.0:.2f}\n"
    return s


async def run_benchmark(server: str, prompts: list[str], num_tasks: int,
                        ref_wav_bytes: bytes | None = None, ref_text: str = "",
                        seed_base: int = 0, log_dir: str | None = None,
                        name: str = "bench") -> dict:
    import grpc.aio

    async with grpc.aio.insecure_channel(
        server,
        options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                 ("grpc.max_send_message_length", 64 * 1024 * 1024)],
    ) as channel:
        stub = F5TTSAioStub(channel)
        # warm: one synthesis outside the timed window (compile/caches)
        await stub.Synthesize(pb.SynthesizeRequest(
            target_text=prompts[0], reference_wav=ref_wav_bytes or b"",
            reference_text=ref_text or "", seed=seed_base, has_seed=True))

        chunks = split_data(prompts, num_tasks)
        t0 = time.time()
        results = await asyncio.gather(*[
            _task(stub, chunk, i, ref_wav_bytes, ref_text, seed_base)
            for i, chunk in enumerate(chunks)
        ])
        elapsed = time.time() - t0
        total_audio = sum(r[0] for r in results)
        latency_data = [x for r in results for x in r[1]]
        report = format_report(elapsed, total_audio, latency_data)
        stats = json.loads((await stub.GetStats(pb.StatsRequest())).json)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"rtf-{name}.txt"), "w") as f:
            f.write(report)
        with open(os.path.join(log_dir, f"stats_summary-{name}.txt"), "w") as f:
            json.dump(stats, f, indent=2)
    lat = [l for (l, _d) in latency_data]
    return {
        "rtf": elapsed / max(total_audio, 1e-9),
        "elapsed_s": elapsed,
        "total_audio_s": total_audio,
        "latency_ms_p50": float(np.percentile(lat, 50) * 1000),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1000),
        "num_tasks": num_tasks,
        "num_prompts": len(prompts),
        "server_stats": stats,
        "report": report,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_grpc-client")
    p.add_argument("--server", default="localhost:50051")
    p.add_argument("--num-tasks", type=int, default=4,
                   help="concurrent client tasks (reference --num-tasks)")
    p.add_argument("--num-prompts", type=int, default=26)
    p.add_argument("--manifest-path", default=None,
                   help="JSONL with target_text (+ optional reference_text/audio_filepath)")
    p.add_argument("--reference-audio", default=None, help="WAV sent with each request")
    p.add_argument("--reference-text", default="")
    p.add_argument("--log-dir", default="./grpc_bench_logs")
    p.add_argument("--name", default=None)
    p.add_argument("--sweep", default=None,
                   help="comma-separated concurrency sweep, e.g. 1,2,4")
    args = p.parse_args(argv)

    if args.manifest_path:
        prompts = []
        with open(args.manifest_path) as f:
            for line in f:
                if line.strip():
                    prompts.append(json.loads(line)["target_text"])
    else:
        prompts = (DEFAULT_PROMPTS * ((args.num_prompts - 1) // len(DEFAULT_PROMPTS) + 1))
    prompts = prompts[: args.num_prompts]

    ref_bytes = None
    if args.reference_audio:
        with open(args.reference_audio, "rb") as f:
            ref_bytes = f.read()

    concurrencies = ([int(x) for x in args.sweep.split(",")] if args.sweep
                     else [args.num_tasks])
    for c in concurrencies:
        # suffix the concurrency when sweeping so reports don't overwrite
        name = (f"{args.name}-c{c}" if args.name else f"c{c}") if len(concurrencies) > 1 \
            else (args.name or f"c{c}")
        res = asyncio.run(run_benchmark(
            args.server, prompts, c, ref_wav_bytes=ref_bytes,
            ref_text=args.reference_text, log_dir=args.log_dir, name=name))
        print(f"=== concurrency {c} ===")
        print(res["report"])
        print("server stats:", json.dumps(res["server_stats"], indent=2))


if __name__ == "__main__":
    main()
