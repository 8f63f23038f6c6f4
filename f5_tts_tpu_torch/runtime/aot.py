"""AOT engine bundles: export the serving programs once, load them with no
model tracing and no ``nvcc``.

JAX counterpart: ``f5_tts_tpu/runtime/aot.py`` (``jax.export`` StableHLO
artifacts plus serialized PJRT executables).  Here an operating point (kind
``mel`` or ``wav``, rows b, bucket n, ref bucket) is three
``torch.export`` programs, saved with ``torch.export.save``:

- ``prelude`` (the ref-mel extraction of the wav entry, the masks, both
  text streams, y0 from the noise, and the AdaLN tables of the whole
  schedule where the backbone has them);
- ``step``, one ODE step (a fused-CFG forward and the Euler or midpoint
  update), which ``AotEngine`` calls NFE times;
- ``epilogue`` (the reference region restored, the frames past the
  duration zeroed, the vocoder and the int16 wire format).

A Picard operating point (``EngineOptions(time_parallel_window=W)``) is
three programs like the live engine's three CUDA graphs: ``picard_prelude``
(inputs -> the ``cfm.PicardRun`` state: the guesses ``Y``, the frozen count
``s``, the window's tiled conditioning and padded AdaLN tables, and the
epilogue's masks), ``sweep`` (one ``cfm.picard_sweep`` as a function of the
state: it returns the new ``Y``, ``s`` and sweep count, which ``AotEngine``
copies back into the state, so a sweep graph replays in place) and the
same ``epilogue`` on ``Y[T]``.  ``AotEngine`` drives the sweeps with the
live engine's host loop (``engine.picard_loop``).  The state's Python ints
(``T``, ``W``) and the options (``picard_tol``) are constants of the
programs, recorded in the meta's ``options``; JAX's ``export_engine`` likewise traces the
Picard while-loop under ``engine.options`` (``f5_tts_tpu/runtime/aot.py``
:183-215).  Picard over a mesh stays live-only: JAX exports with no mesh
hook, and ``AotEngine.enable_time_parallel`` raises.

The step is one program for every step, so a bundle's size and its export
time do not grow with NFE, where one program over the whole loop would
hold NFE unrolled forwards; the engine's live Picard path splits its graphs
the same way.  ``step`` and ``epilogue`` depend only on (b, n), so the mel
and wav points of one (b, n) share them.

As in JAX, **weights are call arguments, not constants**: every parameter
and buffer of the backbone and the vocoder is an input of the programs, and
so is every tensor derived from them (the fused qkv weights, the W8A8 int8
weights and scales, kernel B's tap-major copies, the AdaLN tables, which
the prelude computes).  A bundle holds no weights; any checkpoint of the
model's shapes serves through it.  Its constants are the tables built from
the config alone (rotary and absolute position tables, the timestep
schedule).  The kernels enter the programs as the dispatcher ops
``torch.ops.f5_tts_tpu_torch.flash_attention`` (A), ``conv_pos_fused``
(B) and ``linear_w8a8`` (G), which ``torch.export`` keeps opaque.  The
noise stays an input, drawn outside as the live engine draws it, and the
device crop in ``_trim_wavs`` stays outside the programs.

``warm_artifacts`` is the card's counterpart of packaging executables: it
copies the compiled kernel libraries (``ops/cuda_build.py``
``_build/<digest>/``) into ``<dir>/kernels/<digest>/``, and ``AotEngine``
loads them from there with no ``nvcc``.  A CUDA graph cannot be
serialized: a loaded engine still captures one graph per call key at its
warm-up, as the live engine does.

Departures from JAX: the build runs on the device it targets (the programs
hold the device of their example inputs; there is no cross-platform
lowering), and a bundle that cannot load (another torch version, kernels
built from other sources) raises where JAX prints and recompiles.

Usage:
    engine = InferenceEngine(model, cfg, vocoder=voc)              # build box
    export_engine(engine, "artifacts/", default_specs())           # once
    warm_artifacts("artifacts/")                                   # kernels
    aot = AotEngine("artifacts/", model, cfg, vocoder=voc)         # serving box
    mels, wavs, gf = aot.generate_batch(...)                       # same surface
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch
import torch.nn as nn

from f5_tts_tpu_torch.infer.engine import (
    EngineOptions,
    InferenceEngine,
    PicardParts,
    _clamp_duration,
    decode_wav,
    ref_cond,
)
from f5_tts_tpu_torch.models import cfm
from f5_tts_tpu_torch.models.backbones import get_backbone
from f5_tts_tpu_torch.models.layers import ConvPositionEmbedding
from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.ops import flash_attention as _fa  # noqa: F401  (registers the ops)
from f5_tts_tpu_torch.ops import fused_convpos as _fc  # noqa: F401
from f5_tts_tpu_torch.ops import quant as _q  # noqa: F401

_META = "engine_meta.json"
_KERNELS = "kernels"


def default_specs(batch_sizes=(1, 2), buckets=(1024,), ref_buckets=(512,)):
    """Operating points worth pre-building: the fused wav-in path (serving)
    and the mel-cond path (eval/batcher) at the given shapes."""
    specs = []
    for b in batch_sizes:
        for n in buckets:
            specs.append(("mel", b, n, None))
            for rb in ref_buckets:
                if rb <= n:
                    specs.append(("wav", b, n, rb))
    return specs


def _spec_name(kind: str, b: int, n: int, rb: int | None) -> str:
    return f"{kind}_b{b}_n{n}" + (f"_r{rb}" if rb is not None else "")


# ----------------------------------------------------------------- programs
# Each program is a function of (module, taps, *inputs) run under
# torch.func.functional_call, so the module's parameters and buffers come
# from the weights dict the program takes; ``taps`` maps each
# ConvPositionEmbedding's name to its kernel weight pair.


def _with_taps(module: nn.Module, taps: dict):
    """Point every ConvPositionEmbedding of ``module`` at the pair in
    ``taps`` (a program input) for the call; returns the undo list."""
    undo = []
    for name, m in module.named_modules():
        if isinstance(m, ConvPositionEmbedding) and name in taps:
            undo.append((m, m.taps))
            m.taps = tuple(taps[name])
    return undo


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, so ``functional_call``
    swaps ``module``'s weights for the call."""

    def __init__(self, fn, module: nn.Module | None):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, taps, *args):
        undo = _with_taps(self.m, taps) if self.m is not None else []
        try:
            return self.fn(self.m, *args)
        finally:
            for m, t in undo:
                m.taps = t


class _Program(nn.Module):
    """The exported module: weights (a dict) and taps in, ``fn`` out.  It
    holds no parameter of its own, so the exported program has none."""

    def __init__(self, bound: _Bound):
        super().__init__()
        object.__setattr__(self, "bound", bound)  # not a submodule

    def forward(self, weights, taps, *args):
        return torch.func.functional_call(self.bound, weights, (taps, *args), strict=True)


def _prelude_fn(cfg, opts: EngineOptions, kind: str, n: int, dtype):
    """(backbone, *inputs) -> the setup dict the steps and the epilogue read."""
    sopts = opts.sample_opts()

    def fn(model, *xs):
        if kind == "wav":
            wav_i16, wav_scale, lens, text_ids, duration, noise = xs
            cond = ref_cond(cfg, wav_i16, wav_scale, lens, n, dtype)
        else:
            cond, text_ids, lens, duration, noise = xs
        su = cfm._setup(model, cfg.arch, cond, text_ids, duration, noise.to(cond.dtype), lens,
                        sopts, None, False, False)
        out = {"cond": su.cond, "cond_mask": su.cond_mask, "step_cond": su.step_cond,
               "mask": su.mask, "te_cond": su.te_cond, "y0": su.y0, "extra": dict(su.extra)}
        if su.te_uncond is not None:
            out["te_uncond"] = su.te_uncond
        bb = get_backbone(cfg.arch)
        if _uses_tables(cfg, opts):
            t_dev, _ = cfm.schedule_tensors(sopts.n_steps, sopts.sway_sampling_coef,
                                            sopts.use_epss, dtype, cond.device, sopts.t_start)
            blk, fin = bb.precompute_adaln(model, cfg.arch, t_dev, dtype=dtype)
            out["mods"] = {"blk": blk, "fin": fin}
        return out

    return fn


def _uses_tables(cfg, opts: EngineOptions) -> bool:
    """Whether ``cfm.sample`` precomputes the AdaLN tables (DiT, Euler)."""
    return opts.ode_method == "euler" and hasattr(get_backbone(cfg.arch), "precompute_adaln")


def _step_fn(cfg, opts: EngineOptions):
    """(backbone, x, t, t_mid, dt, mods, setup) -> x after one ODE step,
    as one iteration of ``cfm.sample``'s loop: ``t`` and ``t_mid`` fp32
    0-dim, ``dt`` 0-dim in the compute dtype, ``mods`` the step's AdaLN
    rows ({} without tables)."""
    sopts = opts.sample_opts()

    def fn(model, x, t, t_mid, dt, mods, su):
        b = x.shape[0]
        dtype = x.dtype

        def velocity(y, t32, adaln=None):
            time = t32.expand(b).to(dtype)
            return cfm._velocity(model, cfg.arch, sopts, opts.backend, y, su["step_cond"],
                                 su["te_cond"], su.get("te_uncond"), time, su["mask"],
                                 su["extra"], adaln)

        if opts.ode_method == "midpoint":
            k1 = velocity(x, t)
            x = x + dt * velocity(x + 0.5 * dt * k1, t_mid)
        else:
            adaln = (mods["blk"], mods["fin"]) if mods else None
            x = x + dt * velocity(x, t, adaln)
        return x.to(dtype)

    return fn


_PICARD_STATE = ("Y", "s", "sweeps", "t_pad", "dt_pad", "cond_r", "te_r", "teu_r", "mask_r",
                 "extra_r", "fmask", "denom")


def _picard_prelude_fn(cfg, opts: EngineOptions, kind: str, n: int, dtype):
    """(backbone, *inputs) -> (the Picard state's tensors, the epilogue's
    setup fields): ``cfm.picard_begin`` after the wav entry's ref mel."""
    sopts = opts.sample_opts()

    def fn(model, *xs):
        if kind == "wav":
            wav_i16, wav_scale, lens, text_ids, duration, noise = xs
            cond = ref_cond(cfg, wav_i16, wav_scale, lens, n, dtype)
        else:
            cond, text_ids, lens, duration, noise = xs
        run = cfm.picard_begin.__wrapped__(model, cfg.arch, cond, text_ids, duration,
                                           noise.to(cond.dtype), lens, sopts,
                                           backend=opts.backend)
        st = {k: getattr(run, k) for k in _PICARD_STATE if getattr(run, k) is not None}
        st["extra_r"] = dict(run.extra_r)
        if run.mods is not None:
            st["mods"] = {"blk": run.mods[0], "fin": run.mods[1]}
        su = run.setup
        return st, {"cond": su.cond, "cond_mask": su.cond_mask, "mask": su.mask}

    return fn


def _picard_sweep_fn(cfg, opts: EngineOptions):
    """(backbone, state) -> the state's new (Y, s, sweeps) after one
    ``cfm.picard_sweep``, which runs on copies of them (the program takes
    its state as inputs and does not write them)."""
    sopts = opts.sample_opts()
    T = sopts.n_steps
    W = min(opts.time_parallel_window, T)

    def fn(model, st):
        mods = st.get("mods")
        run = cfm.PicardRun(
            setup=None, Y=st["Y"].clone(), s=st["s"].clone(), sweeps=st["sweeps"].clone(),
            t_pad=st["t_pad"], dt_pad=st["dt_pad"], cond_r=st["cond_r"], te_r=st["te_r"],
            teu_r=st.get("teu_r"), mask_r=st["mask_r"], extra_r=st["extra_r"],
            mods=None if mods is None else (mods["blk"], mods["fin"]), fmask=st["fmask"],
            denom=st["denom"], T=T, W=W, opts=sopts, backend=opts.backend)
        cfm.picard_sweep.__wrapped__(model, cfg.arch, run)
        return run.Y, run.s, run.sweeps

    return fn


def _epilogue_fn(vocoder_type: str, decode: bool):
    """(vocoder, x, setup, lens, duration) -> (mel, int16 wav or None)."""

    def fn(voc, x, su, lens, duration):
        out = torch.where(su["cond_mask"][..., None], su["cond"], x)
        mel = torch.where(su["mask"][..., None], out, torch.zeros_like(out))
        if not decode:
            return mel, None
        return mel, decode_wav.__wrapped__(voc, vocoder_type, mel, lens, duration)

    return fn


def _schedule(opts: EngineOptions, dtype, device):
    """Per-step (t, t_mid, dt) 0-dim device tensors, as ``cfm.sample``
    forms them: t_k and t_k + dt_k / 2 in fp32, dt_k in the compute dtype."""
    sopts = opts.sample_opts()
    ts = cfm.timestep_schedule(sopts.n_steps, sopts.sway_sampling_coef, sopts.use_epss,
                               sopts.t_start)
    _, dt_dev = cfm.schedule_tensors(sopts.n_steps, sopts.sway_sampling_coef, sopts.use_epss,
                                     dtype, device, sopts.t_start)
    t = np.asarray(ts[:-1], np.float32)
    dt32 = (ts[1:] - ts[:-1]).astype(np.float32)
    t_mid = (t + np.float32(0.5) * dt32).astype(np.float32)
    t_dev = torch.as_tensor(t, device=device)
    mid_dev = torch.as_tensor(t_mid, device=device)
    return [(t_dev[k], mid_dev[k], dt_dev[k]) for k in range(len(t))]


def backbone_weights(engine: InferenceEngine) -> tuple[dict, dict]:
    """The backbone's weights as the programs take them: (every parameter
    and buffer by name, the ConvPositionEmbeddings' kernel tap pairs by
    module name), detached."""
    bb = engine.model.transformer
    weights = {f"m.{k}": v.detach() for k, v in bb.named_parameters()}
    weights.update({f"m.{k}": v.detach() for k, v in bb.named_buffers()})
    taps = {name: list(m.taps) for name, m in bb.named_modules()
            if isinstance(m, ConvPositionEmbedding) and m.taps is not None}
    return weights, taps


def vocoder_weights(engine: InferenceEngine) -> dict:
    if engine.vocoder is None:
        return {}
    voc = engine.vocoder
    weights = {f"m.{k}": v.detach() for k, v in voc.named_parameters()}
    weights.update({f"m.{k}": v.detach() for k, v in voc.named_buffers()})
    return weights


_STEP_KEYS = ("step_cond", "te_cond", "te_uncond", "mask", "extra")
_EPILOGUE_KEYS = ("cond", "cond_mask", "mask")


def _part(su: dict, keys) -> dict:
    """The setup fields one program reads (each program takes only those)."""
    return {k: su[k] for k in keys if k in su}


class _Driver:
    """One operating point's three programs, driven as ``cfm.sample`` and
    ``sample_and_decode`` drive the live functions."""

    def __init__(self, prelude, step, epilogue, schedule):
        self.prelude, self.step, self.epilogue = prelude, step, epilogue
        self.schedule = schedule

    def __call__(self, wb, taps, wv, *xs):
        su = self.prelude(wb, taps, *xs)
        mods, step_su = su.get("mods"), _part(su, _STEP_KEYS)
        x = su["y0"]
        for k, (t, t_mid, dt) in enumerate(self.schedule):
            step_mods = {} if mods is None else {"blk": mods["blk"][k], "fin": mods["fin"][k]}
            x = self.step(wb, taps, x, t, t_mid, dt, step_mods, step_su)
        lens, duration = xs[2], xs[-2]
        return self.epilogue(wv, {}, x, _part(su, _EPILOGUE_KEYS), lens, duration)


class _PicardState:
    """A Picard bundle's state between its programs: the tensors (``st``),
    the epilogue's setup fields, and what ``engine.picard_loop`` reads."""

    def __init__(self, st: dict, epi: dict, T: int):
        self.st, self.epi, self.T = st, epi, T
        self.s = st["s"]


class _PicardDriver:
    """One Picard operating point's three programs as the engine's
    ``PicardParts`` on the weights given."""

    def __init__(self, prelude, sweep, epilogue, T: int):
        self.prelude, self.sweep, self.epilogue, self.T = prelude, sweep, epilogue, T

    def parts(self, wb, taps, wv) -> PicardParts:
        def prelude(*xs):
            return _PicardState(*self.prelude(wb, taps, *xs), self.T)

        def sweep(state):
            for k, v in zip(("Y", "s", "sweeps"), self.sweep(wb, taps, state.st)):
                state.st[k].copy_(v)

        def epilogue(state, *xs):
            lens, duration = xs[2], xs[-2]
            return self.epilogue(wv, {}, state.st["Y"][self.T], state.epi, lens, duration)

        return PicardParts(prelude, sweep, epilogue)


def _dummy_inputs(engine: InferenceEngine, kind: str, b: int, n: int, rb: int | None):
    """Request tensors of one operating point, as the engine's public
    methods build them (zeros, a few reference frames, full duration)."""
    cfg, dev = engine.model_cfg, engine.device
    d = cfg.mel.n_mel_channels
    lens = torch.full((b,), min(8, n - 1), dtype=torch.int32, device=dev)
    text = np.zeros((b, n), np.int32)
    text[:, 16:] = -1
    duration = _clamp_duration(np.full((b,), n, np.int32), text, lens.cpu().numpy(), n)
    text_ids = torch.as_tensor(text, device=dev)
    duration = torch.as_tensor(duration, device=dev)
    noise = torch.zeros((b, n, d), dtype=torch.float32, device=dev)
    if kind == "mel":
        cond = torch.zeros((b, n, d), dtype=engine.dtype, device=dev)
        return (cond, text_ids, lens, duration, noise)
    S = rb * engine.hop + cfg.mel.n_fft
    return (torch.zeros((b, S), dtype=torch.int16, device=dev),
            torch.ones((b,), dtype=torch.float32, device=dev), lens, text_ids, duration, noise)


def export_engine(engine: InferenceEngine, out_dir: str, specs=None) -> list[str]:
    """Export the engine's programs for the given (kind, batch, bucket,
    ref_bucket) operating points into ``out_dir`` and write
    ``engine_meta.json``.  Returns the operating points' names.  Each
    program is first run eagerly on the example inputs (the lazily built
    tables then exist as real tensors), then exported on them.  A Picard
    engine (``time_parallel_window > 0``, no mesh) exports its prelude,
    sweep and epilogue (module docstring)."""
    if engine._collective():
        raise ValueError("export_engine takes a one-device engine: mesh hooks and tensor "
                         "parallelism stay live (JAX exports with hooks=(None, None))")
    specs = default_specs() if specs is None else specs
    os.makedirs(out_dir, exist_ok=True)
    mc, opts = engine.model_cfg, engine.options
    decode = engine.vocoder is not None
    wb, taps = backbone_weights(engine)
    wv = vocoder_weights(engine)
    bb_mod, voc_mod = engine.model.transformer, engine.vocoder
    schedule = _schedule(opts, engine.dtype, engine.device)
    programs, points, seconds = {}, {}, {}

    def export(fname, fn, module, args):
        if fname in programs:
            return
        t0 = time.perf_counter()
        prog = _Program(_Bound(fn, module))
        # distinct example inputs: export merges inputs that alias (a program
        # fed one tensor twice would read one input in place of the other)
        args = torch.utils._pytree.tree_map(
            lambda a: a.clone() if torch.is_tensor(a) else a, args)
        with torch.no_grad():
            ep = torch.export.export(prog, args, strict=False)
        if ep.state_dict:
            raise RuntimeError(f"{fname}: the exported program holds weights "
                               f"{sorted(ep.state_dict)[:4]}")
        ep.example_inputs = None  # they hold the weights: the bundle must not
        path = os.path.join(out_dir, fname)
        torch.export.save(ep, path)
        with zipfile.ZipFile(path) as z:
            kept = [i.filename for i in z.infolist() if "sample_inputs" in i.filename
                    and i.file_size]
        if kept:
            raise RuntimeError(f"{fname}: the saved program keeps its example inputs {kept}")
        seconds[fname] = time.perf_counter() - t0
        programs[fname] = {"bytes": os.path.getsize(path),
                           "constants": {k: list(v.shape) for k, v in ep.constants.items()}}

    for kind, b, n, rb in specs:
        if kind == "wav" and rb is None:
            raise ValueError(f"a wav operating point needs a ref bucket: {(kind, b, n, rb)}")
        xs = _dummy_inputs(engine, kind, b, n, None if kind == "mel" else rb)
        if opts.time_parallel_window:
            points[_spec_name(kind, b, n, rb)] = {"kind": kind, "b": b, "n": n,
                                                  "ref_bucket": rb,
                                                  **_export_picard(export, engine, kind, b, n,
                                                                   rb, xs, (wb, taps, wv))}
            continue
        pre = _prelude_fn(mc, opts, kind, n, engine.dtype)
        step = _step_fn(mc, opts)
        epi = _epilogue_fn(engine.vocoder_type, decode)
        with torch.no_grad():  # eager first: builds and caches the tables
            su = _Bound(pre, bb_mod)(taps, *xs)
            k_mods = ({} if "mods" not in su else
                      {"blk": su["mods"]["blk"][0], "fin": su["mods"]["fin"][0]})
            t, t_mid, dt = schedule[0]
            step_args = (su["y0"], t, t_mid, dt, k_mods, _part(su, _STEP_KEYS))
            x = _Bound(step, bb_mod)(taps, *step_args)
            epi_args = (x, _part(su, _EPILOGUE_KEYS), xs[2], xs[-2])
            _Bound(epi, voc_mod)({}, *epi_args)
        names = {"prelude": f"prelude_{_spec_name(kind, b, n, rb)}.pt2",
                 "step": f"step_b{b}_n{n}.pt2", "epilogue": f"epilogue_b{b}_n{n}.pt2"}
        export(names["prelude"], pre, bb_mod, (wb, taps, *xs))
        export(names["step"], step, bb_mod, (wb, taps, *step_args))
        export(names["epilogue"], epi, voc_mod, (wv, {}, *epi_args))
        points[_spec_name(kind, b, n, rb)] = {"kind": kind, "b": b, "n": n, "ref_bucket": rb,
                                              **names}
    meta = {
        "model": mc.name,
        "options": dataclasses.asdict(opts),
        "dtype": str(engine.dtype).removeprefix("torch."),
        "vocoder_type": engine.vocoder_type if decode else None,
        "buckets": list(engine.buckets),
        "device": engine.device.type,
        "torch_version": torch.__version__,
        "kernel_digest": cuda_build.LIBRARY.digest(),
        "artifacts": list(points),
        "points": points,
        "programs": programs,
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return list(points)


def _export_picard(export, engine: InferenceEngine, kind: str, b: int, n: int, rb, xs,
                   weights) -> dict:
    """Export one Picard operating point's prelude, sweep and epilogue
    (each run eagerly first) through ``export``; returns their file names."""
    mc, opts = engine.model_cfg, engine.options
    wb, taps, wv = weights
    bb_mod, voc_mod = engine.model.transformer, engine.vocoder
    pre = _picard_prelude_fn(mc, opts, kind, n, engine.dtype)
    sweep = _picard_sweep_fn(mc, opts)
    epi = _epilogue_fn(engine.vocoder_type, engine.vocoder is not None)
    with torch.no_grad():
        st, epi_su = _Bound(pre, bb_mod)(taps, *xs)
        Y = _Bound(sweep, bb_mod)(taps, st)[0]
        epi_args = (Y[opts.sample_opts().n_steps], epi_su, xs[2], xs[-2])
        _Bound(epi, voc_mod)({}, *epi_args)
    names = {"prelude": f"picard_prelude_{_spec_name(kind, b, n, rb)}.pt2",
             "sweep": f"sweep_b{b}_n{n}.pt2", "epilogue": f"epilogue_b{b}_n{n}.pt2"}
    export(names["prelude"], pre, bb_mod, (wb, taps, *xs))
    export(names["sweep"], sweep, bb_mod, (wb, taps, st))
    export(names["epilogue"], epi, voc_mod, (wv, {}, *epi_args))
    return names


def bundle_bytes(artifact_dir: str) -> int:
    """Bytes of every file in the bundle (programs, meta, kernels)."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(artifact_dir) for f in files)


def warm_artifacts(artifact_dir: str, library: cuda_build.KernelLibrary | None = None) -> int:
    """Copy the compiled kernel libraries (built here first if they are
    not yet) into ``<artifact_dir>/kernels/<digest>/``, so that a serving
    process loads them with no ``nvcc``.  Returns the number packaged."""
    lib = library or cuda_build.LIBRARY
    src = lib.build()
    dst = os.path.join(artifact_dir, _KERNELS, lib.digest())
    os.makedirs(dst, exist_ok=True)
    n = 0
    for source in lib.sources():
        name = cuda_build._lib_name(source)
        shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
        n += 1
    return n


_LOADED: dict[tuple, nn.Module] = {}  # programs loaded in this process, by file


def load_program(path: str) -> nn.Module:
    """The saved program at ``path`` as a callable module, loaded once per
    process and file version (path, mtime, size): engines over one bundle
    share its programs, which hold no weights and no state."""
    st = os.stat(path)
    key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
    if key not in _LOADED:
        _LOADED[key] = torch.export.load(path).module()
    return _LOADED[key]


def read_meta(artifact_dir: str) -> dict:
    """A bundle's ``engine_meta.json``."""
    with open(os.path.join(artifact_dir, _META)) as f:
        return json.load(f)


class AotEngine(InferenceEngine):
    """InferenceEngine whose calls run exported programs: no Python model
    code is traced or run at serving time.  Weights come from the caller's
    ``model`` (the export-time engine's shapes); options, dtype, buckets
    and vocoder type come from the bundle.  A key no program covers, or
    per-call options other than the exported ones (a Picard bundle's
    ``time_parallel_window`` and ``picard_tol`` among them), raise
    ``KeyError``; with ``fallback=True`` they run the live engine instead,
    on the same device and kernels.  On the card each key's programs are
    captured as one CUDA graph at its first call (a Picard key as the live
    engine's three), or at load (``warmup``: by default when the kernels
    came from the bundle)."""

    def __init__(self, artifact_dir: str, model, model_cfg, vocoder=None, fallback: bool = False,
                 warmup: bool | None = None, **kw):
        meta = read_meta(artifact_dir)
        if meta["model"] != model_cfg.name:
            raise ValueError(f"artifacts built for {meta['model']!r}, got {model_cfg.name!r}")
        if meta["torch_version"] != torch.__version__:
            raise RuntimeError(f"artifacts exported by torch {meta['torch_version']}, this is "
                               f"torch {torch.__version__}: rebuild them")
        digest = cuda_build.LIBRARY.digest()
        if meta["kernel_digest"] != digest:
            raise RuntimeError(f"artifacts built against kernel sources {meta['kernel_digest']}, "
                               f"this package's are {digest}: rebuild them")
        opts = EngineOptions(**meta["options"])
        kw.setdefault("options", opts)
        kw.setdefault("dtype", getattr(torch, meta["dtype"]))
        kw.setdefault("buckets", tuple(meta["buckets"]))
        if meta["vocoder_type"]:
            kw.setdefault("vocoder_type", meta["vocoder_type"])
        self.loaded_kernels = 0
        kdir = os.path.join(artifact_dir, _KERNELS)
        if os.path.isdir(kdir):
            path = cuda_build.LIBRARY.use_prebuilt(kdir)
            self.loaded_kernels = len(os.listdir(path))
        super().__init__(model, model_cfg, vocoder=vocoder, **kw)
        self.fallback = fallback
        self._exported_options = opts
        self._decode = meta["vocoder_type"] is not None  # the epilogue decodes
        self._weights = backbone_weights(self)
        self._voc_weights = vocoder_weights(self) if self._decode else {}
        self._schedule = _schedule(opts, self.dtype, self.device)
        hop, n_fft = model_cfg.mel.hop_length, model_cfg.mel.n_fft
        t0 = time.perf_counter()
        self._programs: dict[tuple, _Driver | _PicardDriver] = {}
        for p in meta["points"].values():
            if "sweep" in p:
                drv = _PicardDriver(*(load_program(os.path.join(artifact_dir, p[part]))
                                      for part in ("prelude", "sweep", "epilogue")),
                                    opts.sample_opts().n_steps)
            else:
                drv = _Driver(*(load_program(os.path.join(artifact_dir, p[part]))
                                for part in ("prelude", "step", "epilogue")), self._schedule)
            if p["kind"] == "wav":
                key = ("wav", p["b"], p["ref_bucket"] * hop + n_fft, p["n"])
            else:
                key = ("mel", p["b"], None, p["n"])
            self._programs[key] = drv
        self.load_seconds = time.perf_counter() - t0
        self.meta = meta
        if warmup or (warmup is None and self.loaded_kernels and self.device.type == "cuda"):
            self.warmup()

    def enable_time_parallel(self, mesh) -> None:
        """Picard over a mesh stays live-only: JAX's bundles carry no mesh
        hook (``f5_tts_tpu/runtime/aot.py:194``)."""
        raise NotImplementedError("an AOT bundle serves Picard on one device only; build a "
                                  "live InferenceEngine for Picard over a mesh")

    def warmup(self, n_frames: int = 1024, text_len: int = 64) -> int:
        """Run (on the card: capture) every exported key once on dummy
        inputs, so a first request replays.  Returns the keys warmed (the
        JAX signature's arguments are unused)."""
        d = self.model_cfg.mel.n_mel_channels
        for kind, b, S, n in self._programs:
            seeds = [0] * b
            txt = [np.zeros((16,), np.int32)] * b
            if kind == "mel":
                self.generate_batch([np.zeros((8, d), np.float32)] * b, txt, [n] * b,
                                    seeds=seeds, fetch_mel=False)
            else:  # a ref wav of rb - 1 frames ships at ref bucket rb, S samples
                rb = (S - self.model_cfg.mel.n_fft) // self.hop
                wav = np.zeros(((rb - 1) * self.hop,), np.float32)
                self.generate_batch_from_wavs([wav] * b, txt, [n] * b, seeds=seeds,
                                              fetch_mel=False)
        return len(self._programs)

    def _call(self, entry: str, args: tuple, decode: bool):
        b, n = args[-1].shape[0], args[-1].shape[1]
        key = (entry, b, args[0].shape[1] if entry == "wav" else None, n)
        drv = self._programs.get(key)
        why = f"no AOT artifact for {key} (available: {sorted(self._programs, key=str)})"
        if drv is not None and self.options != self._exported_options:
            drv, why = None, (f"per-call options {self.options} differ from the exported "
                              f"{self._exported_options}")
        if drv is not None and decode != self._decode:
            drv, why = None, f"decode={decode} differs from the exported programs'"
        if drv is None:
            if not self.fallback:
                raise KeyError(f"{why}; rebuild with f5-tts_build-engine or pass "
                               "fallback=True for the live engine")
            return super()._call(entry, args, decode)
        (wb, taps), wv = self._weights, self._voc_weights
        if isinstance(drv, _PicardDriver):
            return self.picard_call(drv.parts(wb, taps, wv))

        def call(*xs):
            with torch.inference_mode():
                return drv(wb, taps, wv, *xs)

        return call


def build_engine(model_name: str = "F5TTS_v1_Base", ckpt: str = "", vocoder: str = "",
                 device: str | None = None, dtype: torch.dtype | None = None,
                 options: EngineOptions = EngineOptions()) -> InferenceEngine:
    """A serving engine of ``model_name`` with a Vocos vocoder: the
    checkpoints' weights, or seeded random ones (backbone seed 0, vocoder
    seed 1, as ``F5TTS(init_random=True)``); ``dtype`` None means bf16 on
    the card and fp32 on the CPU.  The build CLI, the offline benchmark and
    the cold-start script build their engines here."""
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.utils import ckpt as ckpt_util
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device, "build_engine")
    cfg = MODEL_CONFIGS[model_name]
    if ckpt:
        model = CFM(cfg.arch)
        ckpt_util.load_dit_state(model, ckpt_util.load_torch_state(ckpt, use_ema=True))
    else:
        model = _seeded(lambda: CFM(cfg.arch), 0)
    if vocoder:
        voc = Vocos()
        ckpt_util.load_into(voc, ckpt_util.load_torch_state(vocoder, use_ema=False))
    else:
        voc = _seeded(Vocos, 1)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return InferenceEngine(model.to(dev), cfg, vocoder=voc.to(dev), dtype=dtype, options=options)


def main(argv=None):
    """Build CLI (``f5-tts_build-engine``): export the serving programs at
    the requested operating points on this machine's card (``--device
    cpu`` for the CPU), and with ``--warm`` package the compiled kernels
    with them."""
    import argparse

    ap = argparse.ArgumentParser(prog="f5-tts_build-engine")
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--ckpt", default="", help="checkpoint (.pt/.safetensors); random if empty")
    ap.add_argument("--vocoder", default="", help="Vocos weights; random if empty")
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--buckets", type=int, nargs="+", default=[1024])
    ap.add_argument("--ref-buckets", type=int, nargs="+", default=[512])
    ap.add_argument("--quantize", action="store_true", help="W8A8 block linears (kernel G)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--warm", action="store_true",
                    help="also package the compiled kernels with the programs (load with no "
                    "nvcc; the card's machine only)")
    args = ap.parse_args(argv)

    eng = build_engine(args.model, args.ckpt, args.vocoder, args.device,
                       options=EngineOptions(nfe_step=args.nfe, quantize=args.quantize))
    specs = default_specs(args.batches, args.buckets, args.ref_buckets)
    names = export_engine(eng, args.out, specs)
    print(f"wrote {len(names)} operating points to {args.out}:")
    for nm in names:
        print(" ", nm)
    if args.warm:
        n = warm_artifacts(args.out)
        print(f"packaged {n} kernel libraries under {args.out}/{_KERNELS}")


if __name__ == "__main__":
    main()
