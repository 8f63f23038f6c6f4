"""Inference engine: bucketed text -> waveform generation.

JAX counterpart: ``f5_tts_tpu/infer/engine.py``.  ``sample_and_decode_from_wav``
is the counterpart of the fused ``_sample_and_decode_from_wav`` graph:
ref-mel extraction, ``cfm.sample`` (the NFE Euler loop over the fused-CFG
backbone: DiT, UNetT or MMDiT) and the vocoder decode, each on the engine's
device.  It takes the noise
as an explicit tensor; the engine's public methods draw it per row from
``torch.Generator(device).manual_seed(seed)``, so a row's noise depends only
on its seed and the bucket, not on the batch it rides in.

The vocoder is Vocos or BigVGAN, ``vocoder_type`` (by default the model's
``mel.mel_spec_type``, as JAX ``engine.py:243``).  Both run in fp32 on the
generated region rolled to the front of each row, the tail padded with the
log-mel silence floor: Vocos masked to each row's length, BigVGAN over the
whole bucket row with no mask (JAX :150-154).  On the card both run under
PyTorch's default cuDNN setting, which lets fp32 convolutions use TF32
products (``torch.backends.cudnn.allow_tf32``); the engine sets no global
flag.  ``chip_smoke.py`` (phase 19) reports BigVGAN's int16 error and time
against a decode with TF32 off.

JAX runs one compiled XLA program per call; on the card the engine runs one
CUDA graph per call.  Each graph is keyed on what is static in JAX's jit:
the entry (mel or wav), the rows b, the bucket n, the ref-wav length S,
``decode``, the compute dtype and the ``EngineOptions``.  A key is captured
at its first call (as JAX compiles at first call) or ahead of time by
``warmup`` / ``warmup_all``; every call replays it.  A capture first runs the
call once eagerly on the capture stream (library handles, the lazily
built tables, kernel G's workspaces, in a workspace scope of the graph's
own), then records it; the noise is drawn outside the graph and copied
into its static inputs with the rest of the request.  An engine's graphs
share one capture stream and one memory pool, and replay on one engine
stream under one lock (copy-in, replay, clone of the outputs);
the host fetch of the outputs runs outside the lock, so two callers
overlap host and card work.  A replay adds the kernel launches its capture
recorded to their counters (``cuda_build.add_launches``).  A failed
capture raises: nothing runs eagerly in its place.  A CPU engine runs the
module-level functions eagerly, which stay the reference for a replay.

``EngineOptions(time_parallel_window=W)`` samples with the single-device
Picard sampler (``cfm.picard_*``).  Its sweep count depends on the data,
which a static graph cannot hold, so a key captures three graphs: the
prelude (ref mel, text embeddings, AdaLN tables, y0, the window's tiled
conditioning), one sweep, and the epilogue (the masks and the decode).  A
call replays the prelude, then the sweep until the frozen count ``s``,
read by the host after each sweep, reaches the step count, then the
epilogue (``last_sweeps`` keeps the count).  A CPU engine runs the same
three parts eagerly with the same host loop (``picard_loop``), so it keeps
``last_sweeps`` too; ``runtime/aot.AotEngine`` hands its exported
programs to the same loop and captures.

Target durations round up to frame buckets; every dynamic length is a mask.
The text ids are padded to the bucket width, so MMDiT, whose text stream
is capped at ``text_max_pos`` tokens, serves buckets up to that length and
raises above it.  The backbone runs in the engine's dtype (bf16 on the
card), the vocoder in fp32.
``EngineOptions(quantize=True)`` serves W8A8 (``ops/quant.py``, kernel G on
the card): after the cast to the compute dtype and the qkv fusion, the
engine quantizes the backbone's block linears in place from the
dtype-rounded weights, as JAX ``engine.py:234-241`` does; DiT and MMDiT
only (UNetT raises ``ValueError``: the JAX package cannot quantize it
either).

Mesh serving (``infer/serve.BatchServer``; JAX :61-66, 106-134, 246-249):
``EngineOptions.convpos_taps`` is accepted for JAX's signature and routes
nothing: JAX's per-tap ConvPositionEmbedding is the function that kernel B
and its plain version already compute (``models/layers.conv_pos_embed_taps``).
``engine.parallel_hooks`` holds (block_scan, activation_constraint,
time_parallel_mesh), as JAX's: the pipeline's block scan
(``parallel/pipeline.py``) and the sequence-parallel hook
(``parallel/sequence.py``) go to the sampler, and ``enable_time_parallel``
sets the mesh of Picard over ``data``; the hooks are in a graph's key.  A
data-parallel rank replays its own rows' graph and needs no collective
inside it.  Under a hook, or under tensor parallelism (``BatchServer
(tensor_parallel=True)``, whose every block all-reduces over ``model``), a
call issues collectives and runs eagerly on the card, never captured: a
gloo collective cannot be captured, and capturing NCCL's waits for a
multi-card cell.  ``BatchServer`` then runs one batch at a time
(``infer/serve.py``), since two threads' collectives on one group could
interleave in another order on each rank.

Each ``generate_batch`` / ``generate_batch_from_wavs`` is an ``engine.call``
span of the program's tracer (``utils/profiling.py``): ``engine.prepare``
(the host assembly, with ``engine.upload``: the noise draw and the
uploads), ``engine.lock_wait``, ``engine.capture`` for a new key,
``engine.enqueue`` (the input copies, the replay, the output clones; a
replay's counters ``<kernel>.launches``: the launches of each hand-written
kernel in it, by its ``CudaKernel`` name), ``engine.fetch`` (the copies to
the host, which wait for the replay) and ``engine.trim``.  The spans read
the host clock only; off, they cost a flag read each.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from f5_tts_tpu_torch.models import bigvgan, cfm, vocos
from f5_tts_tpu_torch.models.backbones import get_backbone
from f5_tts_tpu_torch.models.configs import ModelConfig
from f5_tts_tpu_torch.models.layers import ConvPositionEmbedding
from f5_tts_tpu_torch.ops import cuda_build, quant, workspace
from f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_prepadded, num_frames, stft_pad_amount
from f5_tts_tpu_torch.utils.profiling import span

SILENCE_FLOOR = float(np.log(1e-5))

DEFAULT_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)


def pick_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"duration {n} frames exceeds the largest bucket {buckets[-1]}")


@dataclass(frozen=True)
class EngineOptions:
    """Serving knobs (JAX ``EngineOptions``).  ``backend``: an attention
    backend name or callable (the ring's, set by ``BatchServer``)."""

    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    use_epss: bool = True
    ode_method: str = "euler"  # "euler" | "midpoint"
    backend: object = "auto"  # attention backend: a name or a callable
    quantize: bool = False  # W8A8 int8 block linears (ops/quant.py, kernel G)
    time_parallel_window: int = 0  # W > 0: the Picard sampler, W steps per sweep
    picard_tol: float = 1e-3
    convpos_taps: bool = False  # JAX's; the port's convpos is one function (docstring)

    def sample_opts(self) -> cfm.SampleOptions:
        return cfm.SampleOptions(steps=self.nfe_step, cfg_strength=self.cfg_strength,
                                 sway_sampling_coef=self.sway_sampling_coef,
                                 use_epss=self.use_epss, ode_method=self.ode_method,
                                 time_parallel_window=self.time_parallel_window,
                                 picard_tol=self.picard_tol)


def _clamp_duration(duration, text_ids, lens, n):
    """cfm.sample's duration rule on the host: at least max(text_len,
    ref_len) + 1, at most the bucket."""
    text_len = np.sum(np.asarray(text_ids) != -1, axis=-1)
    duration = np.maximum(np.maximum(text_len, lens) + 1, duration)
    return np.minimum(duration, n).astype(np.int32)


def draw_noise(seeds, n: int, d: int, device) -> torch.Tensor:
    """[b, n, d] fp32 N(0, 1), row i from its own generator seeded ``seeds[i]``."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        rows.append(torch.randn((n, d), generator=gen, device=device, dtype=torch.float32))
    return torch.stack(rows)


@torch.inference_mode()
def decode_wav(voc, vocoder_type: str, mel_out, lens, duration):
    """The int16 waveform [b, T] of each row's generated region: rolled to
    the front of the row, the tail at the log-mel silence floor so the
    vocoder's tail stays silent, decoded in fp32 (Vocos masked to each
    row's length, BigVGAN over the whole row)."""
    b, n, _ = mel_out.shape
    dev = mel_out.device
    gen_len = duration.to(dev) - lens.to(dev)
    idx = (torch.arange(n, device=dev)[None, :] + lens.to(dev).long()[:, None]) % n
    gen_mel = torch.gather(mel_out, 1, idx[..., None].expand(-1, -1, mel_out.shape[-1]))
    keep = torch.arange(n, device=dev)[None, :] < gen_len[:, None]
    floor = torch.full((), SILENCE_FLOOR, dtype=gen_mel.dtype, device=dev)
    gen_mel = torch.where(keep[..., None], gen_mel, floor).float()
    if vocoder_type == "bigvgan":
        wav = bigvgan.decode(voc, gen_mel)
    else:
        wav = vocos.decode(voc, gen_mel, lens=gen_len)
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)  # truncates like JAX


@torch.inference_mode()
def sample_and_decode(model, voc, model_cfg: ModelConfig, opts: EngineOptions, cond, text_ids,
                      lens, duration, noise, decode: bool = True, vocoder_type: str = "vocos",
                      hooks=(None, None, None)):
    """cond [b, n, d] in the compute dtype -> (mel [b, n, d], int16 wav [b, T] or None).
    ``hooks``: (block_scan, activation_constraint, time_parallel_mesh), the
    engine's ``parallel_hooks``, handed to ``cfm.sample``."""
    mel_out = cfm.sample(model, model_cfg.arch, cond, text_ids, duration,
                         noise.to(cond.dtype), lens=lens, opts=opts.sample_opts(),
                         backend=opts.backend, block_scan=hooks[0],
                         activation_constraint=hooks[1],
                         time_parallel_mesh=hooks[2])
    if not decode or voc is None:
        return mel_out, None
    return mel_out, decode_wav(voc, vocoder_type, mel_out, lens, duration)


def ref_cond(model_cfg: ModelConfig, wav_i16, wav_scale, lens, n: int, dtype):
    """The reference mel of the host-padded int16 ref wav, cut or padded to
    the bucket n and zeroed past ``lens``: ``cond`` [b, n, d] in ``dtype``."""
    wav = wav_i16.float() * (wav_scale[:, None] / 32767.0)
    mel = log_mel_prepadded(wav, model_cfg.mel)  # [b, m_ref, d]
    m_ref = mel.shape[1]
    mel = torch.nn.functional.pad(mel, (0, 0, 0, n - m_ref)) if m_ref < n else mel[:, :n]
    valid = torch.arange(n, device=mel.device)[None, :, None] < lens[:, None, None]
    return torch.where(valid, mel, torch.zeros_like(mel)).to(dtype)


@torch.inference_mode()
def sample_and_decode_from_wav(model, voc, model_cfg: ModelConfig, opts: EngineOptions, wav_i16,
                               wav_scale, lens, text_ids, duration, noise, n: int,
                               decode: bool = True, vocoder_type: str = "vocos",
                               hooks=(None, None, None)):
    """Ref-audio mel extraction + sampling + vocoder.  ``wav_i16`` [b, S] is
    the host-reflect-padded ref wav at a ref-length bucket, ``wav_scale`` [b]
    its dequantization scale; ``noise`` [b, n, d]."""
    cond = ref_cond(model_cfg, wav_i16, wav_scale, lens, n, next(model.parameters()).dtype)
    return sample_and_decode(model, voc, model_cfg, opts, cond, text_ids, lens, duration, noise,
                             decode=decode, vocoder_type=vocoder_type, hooks=hooks)


_CAPTURES = itertools.count()  # workspace scope tokens, one per capture


@dataclass
class CapturedGraph:
    """One engine call recorded as a CUDA graph: its static inputs and
    outputs, the launches of each kernel one replay makes (in
    ``cuda_build.KERNELS`` order), and the seconds its capture took (the
    eager warm-up call included)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    launches: list
    seconds: float


@dataclass
class CapturedPicard:
    """One Picard engine call as three CUDA graphs on the same static
    tensors: ``prelude`` (the inputs -> the Picard state, a ``cfm.PicardRun``
    or an AOT bundle's), ``sweep`` (one sweep, in place) and ``epilogue``
    (-> mel, int16 wav)."""

    inputs: tuple
    prelude: CapturedGraph
    sweep: CapturedGraph
    epilogue: CapturedGraph
    seconds: float


@dataclass
class PicardParts:
    """A Picard call's three functions: ``prelude(*xs)`` -> a state with
    ``s`` (the frozen count, a device tensor) and ``T`` (the step count),
    ``sweep(state)`` (one sweep, in place) and ``epilogue(state, *xs)`` ->
    (mel, int16 wav | None), ``xs`` being the request tensors."""

    prelude: object
    sweep: object
    epilogue: object


def picard_loop(state, sweep) -> int:
    """Sweeps until the frozen count reaches the step count (the host reads
    it after each sweep; at most T sweeps) -> the sweeps run.  ``sweep()``
    runs one (an eager sweep or a graph replay)."""
    sweeps = 0
    while sweeps < state.T:
        sweep()
        sweeps += 1
        if int(state.s) >= state.T:
            break
    return sweeps


def _ref_mel_bucket_pad(wav: np.ndarray, mel_cfg: MelConfig, S: int) -> np.ndarray:
    padded = np.pad(np.asarray(wav, np.float32), stft_pad_amount(mel_cfg), mode="reflect")
    return np.pad(padded, (0, max(0, S - len(padded))))[:S]


class InferenceEngine:
    """Holds the backbone (``CFM.transformer``) and vocoder on one device;
    exposes batch mel / waveform generation.  The engine fuses (and with
    ``options.quantize`` quantizes) the model it is given in place; it
    refuses a model another engine has quantized, so each engine needs a
    model of its own (JAX's parameter trees are immutable, so its engines
    never share this state)."""

    def __init__(self, model, model_cfg: ModelConfig, vocoder=None, dtype=torch.float32,
                 buckets=DEFAULT_BUCKETS, options: EngineOptions = EngineOptions(),
                 vocoder_type: str | None = None):
        self.model_cfg = model_cfg
        self.vocoder_type = vocoder_type or model_cfg.mel.mel_spec_type
        self.dtype = dtype
        self.buckets = buckets
        self.options = options
        if quant.holds_w8a8(model):
            raise ValueError("the model already holds another engine's W8A8 weights: build "
                             "each engine on its own model")
        self.model = model.to(dtype=dtype).eval()
        self.device = next(self.model.parameters()).device
        backbone = get_backbone(model_cfg.arch)
        if hasattr(backbone, "fuse_for_inference"):  # DiT and UNetT, as JAX engine.py:231-236
            backbone.fuse_for_inference(self.model.transformer)
        if options.quantize:  # from the dtype-rounded weights, as JAX engine.py:238-241
            quant.quantize_dit_blocks(self.model.transformer, model_cfg.arch)
        for m in self.model.modules():  # the convpos kernel's weight layout, made once
            if isinstance(m, ConvPositionEmbedding):
                m.freeze_taps()
        self.vocoder = None if vocoder is None else vocoder.to(self.device, torch.float32).eval()
        self.hop = model_cfg.mel.hop_length
        # exact-bytes cache of device-resident int16 ref uploads (see _ref_wav_device)
        self._ref_dev_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.graphs: dict[tuple, CapturedGraph | CapturedPicard] = {}  # CUDA: one per call key
        self.last_sweeps: int | None = None  # the sweeps of the last Picard call
        self._graph_lock = threading.Lock()
        # (block_scan, activation_constraint, time_parallel_mesh) for mesh
        # serving, set by BatchServer and enable_time_parallel; in every
        # graph's key (JAX :246-249)
        self.parallel_hooks = (None, None, None)
        self.tensor_parallel = False  # set by BatchServer(tensor_parallel=True)
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
            self._stream = torch.cuda.Stream(self.device)  # every replay runs here
            self._scopes: list = []  # the graphs' kernel workspaces, dropped with the engine
            weakref.finalize(self, workspace.release_scopes, self._scopes)

    def enable_time_parallel(self, mesh) -> None:
        """Picard over ``mesh`` (JAX ``enable_time_parallel``): with
        ``EngineOptions(time_parallel_window=W)`` each of the ``data`` ranks
        evaluates its W*b / data rows of every sweep's window and the
        velocities are all-gathered (``cfm.picard_sweep``); the batch stays
        whole on every rank.  Every rank of the mesh makes the same calls.
        Call it before the first request; the calls then run eagerly (a
        collective per sweep)."""
        if self.options.time_parallel_window <= 0:
            raise ValueError("set EngineOptions(time_parallel_window=W) to use time parallelism "
                             "(JAX asserts the same, engine.py:262)")
        self.parallel_hooks = (self.parallel_hooks[0], self.parallel_hooks[1], mesh)

    def _collective(self) -> bool:
        """Whether an engine call issues collectives (a mesh hook or tensor
        parallelism), so it runs eagerly: a gloo collective cannot sit in a
        CUDA graph, and NCCL's in a captured graph awaits a multi-card cell."""
        return self.tensor_parallel or any(h is not None for h in self.parallel_hooks)

    def _run(self, entry: str, args: tuple, decode: bool):
        """(mel, int16 wav | None) on the device for the request tensors
        ``args`` of ``sample_and_decode`` (entry "mel": cond, text_ids, lens,
        duration, noise) or ``sample_and_decode_from_wav`` ("wav": wav_i16,
        wav_scale, lens, text_ids, duration, noise).  A CPU engine calls the
        function; a CUDA engine replays the call's graph(s), capturing them
        first if the key is new."""
        opts = self.options
        n = args[-1].shape[1]  # the noise [b, n, d]
        call = self._call(entry, args, decode)
        if self.device.type != "cuda" or self._collective():
            with span("engine.enqueue") as sp:  # eager: the call itself
                out = call(*args)  # a call with collectives runs eagerly (module docstring)
                if opts.time_parallel_window:
                    sp.set(sweeps=self.last_sweeps)
            return out
        key = (entry, args[0].shape[0], n, args[0].shape[1] if entry == "wav" else None, decode,
               self.dtype, opts, self.parallel_hooks)
        cur = torch.cuda.current_stream(self.device)
        with span("engine.lock_wait"):
            self._graph_lock.acquire()
        try:
            with torch.inference_mode():
                g = self.graphs.get(key)
                if g is None:
                    with span("engine.capture"):
                        g = self.graphs[key] = (self._capture_picard(call, args)
                                                if opts.time_parallel_window else
                                                self._capture(call, args))
                with span("engine.enqueue") as sp:
                    self._stream.wait_stream(cur)  # the request's inputs are ready
                    with torch.cuda.stream(self._stream):
                        for dst, src in zip(g.inputs, args):
                            dst.copy_(src)
                        if isinstance(g, CapturedPicard):
                            outputs, launches = self._replay_picard(g)
                            sp.set(sweeps=self.last_sweeps)
                        else:
                            g.graph.replay()
                            outputs, launches = g.outputs, g.launches
                        out = tuple(None if o is None else o.clone() for o in outputs)
                    cuda_build.add_launches(launches)
                    for kernel, c in zip(cuda_build.KERNELS, launches):
                        if c:
                            sp.count(f"{kernel.name}.launches", c)
                    cur.wait_stream(self._stream)  # the caller's fetch waits for this replay only
                    for o in out:
                        if o is not None:
                            o.record_stream(cur)
        finally:
            self._graph_lock.release()
        return out

    def _call(self, entry: str, args: tuple, decode: bool):
        """The function of one engine call on the request tensors ``args``
        (see ``_run``): the module-level ``sample_and_decode`` or
        ``sample_and_decode_from_wav`` on the engine's model, or with no
        hook the Picard parts (``_picard_parts``) under ``picard_call``
        (``AotEngine`` returns its exported programs' instead)."""
        opts, n = self.options, args[-1].shape[1]
        model, voc, vt = self.model.transformer, self.vocoder, self.vocoder_type
        hooks = self.parallel_hooks
        if opts.time_parallel_window and all(h is None for h in hooks):
            return self.picard_call(self._picard_parts(entry, decode, n))

        def call(*xs):
            if entry == "mel":
                return sample_and_decode(model, voc, self.model_cfg, opts, *xs, decode=decode,
                                         vocoder_type=vt, hooks=hooks)
            return sample_and_decode_from_wav(model, voc, self.model_cfg, opts, *xs, n,
                                              decode=decode, vocoder_type=vt, hooks=hooks)

        return call

    def _record(self, fn, *args) -> CapturedGraph:
        """``fn(*args)`` recorded as a CUDA graph on the capture stream, in
        the engine's pool (nothing runs).  The launches during the capture
        are taken back off the counters and kept as the graph's launches
        per replay."""
        graph = torch.cuda.CUDAGraph()
        before = cuda_build.launch_counts()
        try:
            # thread_local: another thread may fetch its outputs meanwhile
            with torch.cuda.graph(graph, pool=self._pool, stream=self._capture_stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(*args)
        finally:
            after = cuda_build.launch_counts()
            for kern, c in zip(cuda_build.KERNELS, before):
                kern.launches = c
        return CapturedGraph(graph, args, outputs, [a - b for a, b in zip(after, before)], 0.0)

    def _warm(self, call, args):
        """Copies of ``args`` and a workspace scope of their own, after one
        eager ``call`` on them on the capture stream (lazily built tables,
        library handles, kernel G's workspaces)."""
        cur, stream = torch.cuda.current_stream(self.device), self._capture_stream
        inputs = tuple(a.clone() for a in args)
        stream.wait_stream(cur)
        token = ("engine graph", next(_CAPTURES))
        self._scopes.append(token)
        with workspace.scope(token), torch.cuda.stream(stream):
            call(*inputs)
        return inputs, token

    def _capture(self, call, args) -> CapturedGraph:
        """Record ``call`` on copies of ``args`` as one CUDA graph, in a
        workspace scope of the graph's own, after one eager call."""
        t0 = time.perf_counter()
        inputs, token = self._warm(call, args)
        with workspace.scope(token):
            g = self._record(call, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(self._capture_stream)
        g.seconds = time.perf_counter() - t0
        return g

    def _picard_parts(self, entry: str, decode: bool, n: int) -> PicardParts:
        """The live Picard call's parts on the engine's model: the prelude
        (``cfm.picard_begin``, after the ref mel of the wav entry), the
        in-place ``cfm.picard_sweep`` and the epilogue (``picard_finish``,
        then the vocoder)."""
        model, cfg, opts = self.model.transformer, self.model_cfg, self.options

        def prelude(*xs):
            if entry == "wav":
                wav_i16, wav_scale, lens, text_ids, duration, noise = xs
                cond = ref_cond(cfg, wav_i16, wav_scale, lens, n, self.dtype)
            else:
                cond, text_ids, lens, duration, noise = xs
            return cfm.picard_begin(model, cfg.arch, cond, text_ids, duration,
                                    noise.to(cond.dtype), lens, opts.sample_opts(),
                                    backend=opts.backend)

        def epilogue(run, *xs):
            lens, duration = xs[2], xs[-2]
            mel_out = cfm.picard_finish(run)
            if not decode or self.vocoder is None:
                return mel_out, None
            return mel_out, decode_wav(self.vocoder, self.vocoder_type, mel_out, lens, duration)

        return PicardParts(prelude, lambda run: cfm.picard_sweep(model, cfg.arch, run), epilogue)

    def picard_call(self, parts: PicardParts):
        """One Picard call run eagerly: the prelude, ``picard_loop`` over the
        sweep, the epilogue; it sets ``last_sweeps``.  The parts ride on the
        function (``.picard_parts``) for ``_capture_picard``."""

        def call(*xs):
            with torch.inference_mode():
                run = parts.prelude(*xs)
                self.last_sweeps = picard_loop(run, lambda: parts.sweep(run))
                return parts.epilogue(run, *xs)

        call.picard_parts = parts
        return call

    def _capture_picard(self, call, args) -> CapturedPicard:
        """The Picard call's prelude, sweep and epilogue (``call.picard_parts``)
        recorded as three graphs over one set of static tensors, after one
        eager call."""
        t0 = time.perf_counter()
        parts = call.picard_parts
        inputs, token = self._warm(call, args)
        with workspace.scope(token):
            pre = self._record(parts.prelude, *inputs)
            sweep = self._record(parts.sweep, pre.outputs)
            epi = self._record(parts.epilogue, pre.outputs, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(self._capture_stream)
        return CapturedPicard(inputs, pre, sweep, epi, time.perf_counter() - t0)

    def _replay_picard(self, g: CapturedPicard):
        """The prelude, ``picard_loop`` over sweep replays, the epilogue ->
        (outputs, launches of the whole call)."""
        g.prelude.graph.replay()
        sweeps = picard_loop(g.prelude.outputs, g.sweep.graph.replay)
        g.epilogue.graph.replay()
        self.last_sweeps = sweeps
        launches = [p + sweeps * w + e for p, w, e in
                    zip(g.prelude.launches, g.sweep.launches, g.epilogue.launches)]
        return g.epilogue.outputs, launches

    def graph_pool_bytes(self) -> int:
        """Bytes the CUDA allocator holds in the engine's graph pool."""
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def _ref_wav_device(self, wav_i16: np.ndarray, b: int, S: int) -> torch.Tensor:
        """LRU of the broadcast int16 ref upload, keyed by exact bytes:
        streaming and repeated requests reuse one reference across calls."""
        key = (wav_i16.tobytes(), b, S)
        dev = self._ref_dev_cache.pop(key, None)
        if dev is None:
            host = np.broadcast_to(wav_i16, (b, S)).copy()
            dev = torch.from_numpy(host).to(self.device)
        self._ref_dev_cache[key] = dev
        while len(self._ref_dev_cache) > 8:
            self._ref_dev_cache.popitem(last=False)
        return dev

    def _seeds(self, seeds, b):
        return list(np.random.randint(0, 2**31 - 1, size=b)) if seeds is None else seeds

    def _trim_wavs(self, wav, duration, lens):
        """Dequantize the int16 waveform and cut each row to its generated
        length ((frames - 1) * hop samples for Vocos, frames * hop for
        BigVGAN).  The generated region
        sits at the front of each row, so the device array is first cropped
        to the batch's longest row (rounded up to 128 frames) before the copy
        to the host."""
        gen_frames = [int(d - ln) for d, ln in zip(duration, lens)]
        wavs = []
        if wav is not None:
            with span("engine.fetch") as sp:
                if gen_frames:
                    crop_f = -(-max(max(gen_frames), 1) // 128) * 128
                    wav = wav[:, : min(crop_f * self.hop, wav.shape[1])]
                wav = wav.cpu()
                sp.count("bytes", wav.numel() * wav.element_size())
            with span("engine.trim"):
                wav_np = wav.numpy().astype(np.float32) / 32767.0
                for i, gf in enumerate(gen_frames):
                    n_samp = (max(gf - 1, 0) * self.hop if self.vocoder_type == "vocos"
                              else gf * self.hop)
                    wavs.append(wav_np[i, :n_samp])
        return wavs, gen_frames

    def ref_mel(self, wav: np.ndarray) -> np.ndarray:
        """Reference-audio log-mel [n_ref, d] (center=True parity through a
        host reflect-pad and bucketed frames)."""
        mel_cfg = self.model_cfg.mel
        n_ref = num_frames(len(wav), mel_cfg)
        S = pick_bucket(n_ref, self.buckets) * self.hop + mel_cfg.n_fft
        padded = _ref_mel_bucket_pad(wav, mel_cfg, S)
        with torch.inference_mode():
            mel = log_mel_prepadded(torch.from_numpy(padded[None]).to(self.device), mel_cfg)
        return mel[0, :n_ref].cpu().numpy()

    def _text_matrix(self, text_ids_list, n):
        text_ids = np.full((len(text_ids_list), n), -1, np.int32)
        for i, t in enumerate(text_ids_list):
            text_ids[i, : min(len(t), n)] = t[:n]
        return text_ids

    def _to_dev(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _fetch_mel(self, mel_out, fetch_mel: bool):
        if not fetch_mel:
            return None
        with span("engine.fetch") as sp:
            mel_np = mel_out.float().cpu().numpy()
            sp.count("bytes", mel_np.nbytes)
        return mel_np

    def generate_batch(self, ref_mels, text_ids_list, durations, seeds=None, decode=True,
                       fetch_mel=True):
        """Mel-conditioned generation -> (mels [b, n, d] fp32 | None, wavs, gen_frames)."""
        b = len(ref_mels)
        d = self.model_cfg.mel.n_mel_channels
        n = pick_bucket(max(durations), self.buckets)
        with span("engine.call", entry="mel", b=b, n=n, durs=durations):
            with span("engine.prepare"):
                cond = np.zeros((b, n, d), np.float32)
                lens = np.zeros((b,), np.int32)
                for i, m in enumerate(ref_mels):
                    cond[i, : len(m)] = m
                    lens[i] = len(m)
                text_ids = self._text_matrix(text_ids_list, n)
                duration = _clamp_duration(np.asarray(durations, np.int32), text_ids, lens, n)
                with span("engine.upload") as up:
                    noise = draw_noise(self._seeds(seeds, b), n, d, self.device)
                    args = (self._to_dev(cond).to(self.dtype), self._to_dev(text_ids),
                             self._to_dev(lens), self._to_dev(duration), noise)
                    if up:
                        up.count("bytes", sum(a.numel() * a.element_size() for a in args))
            mel_out, wav = self._run("mel", args, decode and self.vocoder is not None)
            mel_np = self._fetch_mel(mel_out, fetch_mel)
            wavs, gen_frames = self._trim_wavs(wav, duration, lens)
        return mel_np, wavs, gen_frames

    def generate_batch_from_wavs(self, ref_wavs, text_ids_list, durations, seeds=None,
                                 decode=True, fetch_mel=True):
        """Generation from per-row reference waveforms, mel extraction on the
        device; rows ship int16 at the ref-length bucket of the longest ref."""
        b = len(ref_wavs)
        mel_cfg = self.model_cfg.mel
        n = pick_bucket(max(durations), self.buckets)
        with span("engine.call", entry="wav", b=b, n=n, durs=durations):
            with span("engine.prepare"):
                ref_frames = [len(w) // self.hop for w in ref_wavs]
                S = (pick_bucket(min(max(ref_frames) + 1, n), self.buckets) * self.hop
                     + mel_cfg.n_fft)
                shared = all(w is ref_wavs[0] for w in ref_wavs)
                wavs_i16 = np.zeros((b, S), np.int16)
                scales = np.zeros((b,), np.float32)
                for i, w in enumerate(ref_wavs[:1] if shared else ref_wavs):
                    padded = _ref_mel_bucket_pad(w, mel_cfg, S)
                    # normalize only if clipping
                    scale = max(max(float(np.abs(padded).max()), 1e-6), 1.0)
                    wavs_i16[i] = np.round(padded / scale * 32767.0).astype(np.int16)
                    scales[i] = scale
                if shared:
                    scales[:] = scales[0]
                lens = np.asarray([min(rf, n) for rf in ref_frames], np.int32)
                text_ids = self._text_matrix(text_ids_list, n)
                duration = _clamp_duration(np.asarray(durations, np.int32), text_ids, lens, n)
                with span("engine.upload") as up:
                    wav_dev = (self._ref_wav_device(wavs_i16[0], b, S) if shared
                               else self._to_dev(wavs_i16))
                    noise = draw_noise(self._seeds(seeds, b), n, mel_cfg.n_mel_channels,
                                       self.device)
                    args = (wav_dev, self._to_dev(scales), self._to_dev(lens),
                            self._to_dev(text_ids), self._to_dev(duration), noise)
                    if up:
                        up.count("bytes", sum(a.numel() * a.element_size() for a in args))
            mel_out, wav = self._run("wav", args, decode and self.vocoder is not None)
            mel_np = self._fetch_mel(mel_out, fetch_mel)
            wavs, gen_frames = self._trim_wavs(wav, duration, lens)
        return mel_np, wavs, gen_frames

    def generate_batch_from_wav(self, ref_wav, text_ids_list, durations, seeds=None, decode=True,
                                fetch_mel=True):
        """One reference waveform shared by every row (the chunks of one
        utterance): its int16 upload is cached by exact bytes."""
        return self.generate_batch_from_wavs([ref_wav] * len(text_ids_list), text_ids_list,
                                             durations, seeds=seeds, decode=decode,
                                             fetch_mel=fetch_mel)

    def warmup(self, n_frames: int = 1024, text_len: int = 64) -> None:
        d = self.model_cfg.mel.n_mel_channels
        ref = np.zeros((n_frames // 4, d), np.float32)
        txt = np.zeros((text_len,), np.int32)
        self.generate_batch([ref], [txt], [n_frames - 1], seeds=[0])

    def warmup_all(self, buckets=None, batch_sizes=(1,), fused: bool = True,
                   warm_crops: bool = True) -> None:
        """Capture the CUDA graph of every (bucket, batch) pair a server will
        see, for the fused (wav) or the mel entry (on the CPU: run each
        call).  A graph lives in its process: a restarted server captures
        again.  ``warm_crops`` is kept for the JAX signature; the port crops
        the fetched wav by a plain slice with no executable behind it, so
        it warms nothing more."""
        d = self.model_cfg.mel.n_mel_channels
        sr = self.model_cfg.mel.target_sample_rate
        for n in buckets or self.buckets:
            for b in batch_sizes:
                txts = [np.zeros((min(64, n),), np.int32)] * b
                durs = [n - 1] * b
                if fused:
                    wav = np.zeros(int(min(n // 4 * self.hop, 11 * sr)), np.float32)
                    self.generate_batch_from_wav(wav, txts, durs, seeds=[0] * b, fetch_mel=False)
                else:
                    ref = np.zeros((n // 4, d), np.float32)
                    self.generate_batch([ref] * b, txts, durs, seeds=[0] * b, fetch_mel=False)
