"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything a cell is made of is found by name:
the cell in ``BENCHMARK.json``, its configuration in the file that names,
its traffic mix in ``benchmark/traffic/<traffic>.json``, the code of the
mix's ``kind`` in ``benchmark/kinds/<kind>.py``, each per-layer metric's
reader in ``benchmark/metrics/<metric>.py`` and the cell's correctness
limits in ``benchmark/limits/<cell>.json``.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
timed on the host; with ``--trace 1`` its per-layer metrics, from a run that
profiles a bounded slice of its window.  The last key of the line,
``checks``, holds every number the correctness comparison made beside its
limit; the same lines end standard error, after the seconds of the
set-up's timed phases.  The run fails, and prints no
result, without a CUDA device, or if JAX or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "optax", "f5_tts_tpu", "f5_tts")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T_IMPORT - process_age_s()  # the process's start on the perf_counter clock


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["F5TTS_KERNEL_BUILD_DIR"] = os.path.join(cache, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"  # keep transformers, should anything load it, off JAX
    os.environ["USE_JAX"] = "0"


def banned_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in BANNED})


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, looked up by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(root, "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root, c["file"])
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return load_json(self.root, "benchmark", "traffic", name + ".json")

    def limits(self, cell: str) -> dict:
        return load_json(self.root, "benchmark", "limits", cell + ".json")

    def kind(self, kind: str):
        return importlib.import_module(f"benchmark.kinds.{kind}")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end (``trace`` false) or per-layer metrics."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: str = ROOT, control: str | None = None) -> dict:
    """One run of a cell on ``device``: the result line's dict (without
    ``device``), after the window, the memory reading and the comparison.
    ``control`` puts the correctness control in the program's place
    (``benchmark/control.py``); a benchmark run has none."""
    import torch

    from benchmark.trace import Spans

    bench = Bench(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    kind = bench.kind(mix["kind"])
    spans = Spans()
    state = kind.setup(cfg, mix, seed, seconds, bool(trace), device, spans, control)
    t_window = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = kind.window(state, t_window)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    reserved = max(setup_peak, torch.cuda.max_memory_reserved(device)) if cuda else 0
    found = banned_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
    ctx = out["ctx"]
    tr = out.get("trace")
    ctx.update(trace=None if tr is None else tr.summary, cfg=cfg, mix=mix, cell=cell,
               seconds=seconds, spans=spans, peak_bytes=peak,
               setup_s=t_window - T_START)
    metrics = {}
    for m in bench.metrics(workload, bool(trace)):
        if m["name"] == "setup_s":
            value = t_window - T_START
        elif trace:
            value = bench.reader(m["name"])(ctx)
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind.release(state)
    limits = bench.limits(workload)
    checks = kind.check(state, out, limits)
    correct = (out["attempted"] > 0 and out["failed"] == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    res = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "memory_peak_bytes": reserved}
    summary = ctx["trace"]
    if trace and summary is not None:
        res["busy_s"], res["window_s"] = summary["busy_s"], summary["window_s"]
        res["breakdown"] = {"device_ops": [[k, v] for k, v in summary["device_ops"]],
                            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"]]}
    res["setup_phases"] = {s[0]: s[2] - s[1] for s in spans.items if s[0].startswith("setup.")}
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch

    chips = Bench().cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if "busy_s" in res:
        device["busy_s"], device["window_s"] = res.pop("busy_s"), res.pop("window_s")
    checks = res.pop("checks")
    for name, sec in res.pop("setup_phases").items():
        print(f"{name}: {sec!r} s", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
