"""The correctness control of a cell, and the faults its comparison must
catch, read at the cell's own size.  Not part of a benchmark run.

    python3 -m benchmark.control --workload <name> --seeds <a,b,c> --seconds <s> [--controls k]

Each seed prints one JSON line with the numbers the comparison gives:

- serving, mode "program" (DiT): a whole run of the cell with the program's
  own W8A8 path switched on (``EngineOptions(quantize=True)``, kernel G),
  one step below its bf16, and nothing else changed: its checks and
  whether it came out correct;
- serving, mode "reference" (the default for UNetT, which has no W8A8
  path): the fp8 reference in the program's place for the mel, the bf16
  reference Vocos for the waveform;
- training: the program's readings on every seed and, on the first
  ``--controls`` seeds, the fp8 reference and the fault "half of the batch
  left out, the mean over the rest", planted in the reference, each against
  the fp32 reference.  A state left unchanged, or an EMA that is never
  updated, reads 1 on ``grad_gap``, ``change_gap`` or ``ema_gap`` by their
  definition.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run


def serving(workload: str, seed: int, seconds: float, device: str = "cuda",
            root: str = run.ROOT, mode: str | None = None) -> dict:
    """One seed's run with the control in the program's place: "program"
    (its W8A8 path; the default where it has one, DiT) or "reference".
    {check: value, ..., "correct": bool}."""
    bench = run.Bench(root)
    dit = bench.config(bench.cell(workload)["config"])["backbone"] == "DiT"
    mode = mode or ("program" if dit else "reference")
    res = run.run(workload, seed, seconds, False, device, root, control=mode)
    return {**{k: v["value"] for k, v in res["checks"].items()}, "correct": res["correct"]}


def training(workload: str, seed: int, device: str = "cuda", root: str = run.ROOT,
             controls: bool = True) -> dict:
    """(program, and with ``controls`` the control and the half-batch fault)
    readings of one seed, from one set-up of the cell (the program's checked
    steps)."""
    from benchmark.check import control_prec
    from benchmark.kinds import train as T
    from benchmark.trace import Spans

    bench = run.Bench(root)
    cell = bench.cell(workload)
    st = T.setup(bench.config(cell["config"]), bench.mix(cell["traffic"]), seed, 0.0, False,
                 device, Spans())
    T.release(st)
    ref = T.reference_steps(st)
    out = {"program": T.gaps(T.program_readings(st), ref)}
    if controls:
        out["control"] = T.gaps(T.reference_steps(st, control_prec(device)), ref)
        out["half_batch"] = T.gaps(T.reference_steps(st, keep_rows=0.5), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--mode", choices=("program", "reference"), default=None,
                   help="serving: the program's W8A8 path or the fp8 reference (default: "
                        "the program's where it has one)")
    p.add_argument("--controls", type=int, default=3,
                   help="training: the number of seeds, first, that also read the control "
                        "and the half-batch fault")
    args = p.parse_args(argv)
    run.set_cache_dirs()
    bench = run.Bench()
    kind = bench.mix(bench.cell(args.workload)["traffic"])["kind"]
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        if kind == "train":
            out = training(args.workload, s, controls=i < args.controls)
        else:
            out = serving(args.workload, s, args.seconds, mode=args.mode)
        print(json.dumps({"workload": args.workload, "seed": s, "mode": args.mode, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
