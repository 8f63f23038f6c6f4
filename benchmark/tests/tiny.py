"""A copy of the benchmark's data at a size the CPU runs in seconds: every
configuration cut to two blocks of 64 channels (Vocos to two of 32), every
mix to NFE 2 and a handful of requests or utterances, and the open-loop cell
added."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make(dst: str) -> str:
    """The tiny copy under ``dst`` (BENCHMARK.json and benchmark/); returns it."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["arch"].update(dim=64, depth=2, heads=2, dim_head=64)
        if cfg["backbone"] == "DiT":
            cfg["arch"].update(text_dim=32, conv_layers=1)
        cfg["vocoder"].update(dim=32, intermediate_dim=64, num_layers=2)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dst, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            m = json.load(f)
        if m["kind"] == "offline":
            m.update(nfe=2, pool=12, chunk=8, trace_chunk=4, check_sample=12, max_total_frames=768)
        else:
            m.update(frames_threshold=3000, max_samples=4, pool=40, check_steps=2, trace_steps=2,
                     utt_s={"median": 3.0, "sigma": 0.3, "clip": [1.5, 6.0]},
                     ref_block_frames=1000, resume_update=20008)
        with open(path, "w") as f:
            json.dump(m, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst

