"""W8A8 int8 serving: row / column quantization, the int8 matrix product
(kernel G) and its plain version, and the backbone walk that quantizes a
model's block linears.

JAX counterpart: ``f5_tts_tpu/ops/quant.py``: ``quantize_rows`` /
``quantize_cols`` (:19-32), the Pallas ``_kernel`` (:35-43) through
``int8_matmul`` (:47-78), ``quantized_linear`` (:81-89),
``quantize_linear_params`` (:95-106) and ``quantize_dit_blocks``
(:109-129); the quantized branch of ``layers.linear`` (``models/layers.py``
:52-65) is ``linear_w8a8`` here.

Layout: the port holds a quantized weight as nn.Linear does, ``w_q`` int8
[n, k] (k contiguous) with ``w_scale`` fp32 [n]; JAX holds [k, n] and
[1, n].  [n, k] is K-major, the only order ``wgmma`` takes for 8-bit
operands.  ``quantize_cols`` keeps JAX's [k, n] signature for the tests.

Numerics, as JAX: activations are quantized in their own dtype (bf16 on the
card): the row max, the scale ``max(amax, 1e-8) / 127`` and ``x / scale``
are each rounded to x's dtype, rounded half to even, clipped to +-127, and
only the scale is then cast to fp32.  Both divisions are true divisions on
either device (PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, so the scale divides by a tensor of 127).  Weights are
quantized from the compute-dtype weights upcast to fp32, as the JAX engine
does (``infer/engine.py:234-241``: fuse, cast, quantize).  The product is
``float(int32 sum) * x_scale * w_scale`` in fp32, in that order; the linear
casts it to x's dtype and only then adds the bias.

Kernel G (``csrc/int8_matmul.cu``) has two instances, dispatched by device
(a CPU tensor runs the plain version; a CUDA tensor launches the kernel,
and anything it does not take raises):

- ``int8_matmul``: the TPU kernel's function, int8 in, fp32 out;
  ``KERNEL.launches`` counts it.  Only ``quantized_linear`` (a test form)
  and direct callers use it.
- ``linear_w8a8``: the serving linear, one launch per call that quantizes
  x's rows, multiplies and applies the cast and the bias;
  ``KERNEL_LINEAR.launches`` counts it.  ``layers.linear`` and ``mha`` call
  it for every quantized linear, so on the card ``quantize_rows``, the cast
  and the bias launch nothing.

Both split k across blocks when there are fewer output tiles than SMs
(``split_k``).  The per-tile arrival counters and the serving instance's
grid barrier word, its quantized rows and the split partial sums live in
the current stream's workspaces (``ops/workspace.py``): launches on two
streams never share them, and a CUDA graph's are never freed under it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn as nn

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel
from f5_tts_tpu_torch.ops.workspace import workspace

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("int8_matmul", "int8_matmul.cu",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
KERNEL_LINEAR = CudaKernel("int8_linear", "int8_matmul.cu",
                           [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
K_MAX = 2**31 // 127**2  # the longest k whose int32 sum cannot overflow
TILE_M, TILE_N, TILE_K = 128, 256, 128  # kernel G's output tile and k step
SPLIT_MAX = 8
SPLIT_MIN_STEPS = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DtypeCode


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 by true division in t's dtype on either device: a 0-dim
    tensor on t's device, not a Python scalar, which PyTorch's CUDA
    division turns into a product by 1/127 (one ulp off in some rows)."""
    return t / t.new_full((), 127.0)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[m, k] -> (int8 [m, k], fp32 scales [m, 1]); symmetric per row, in x's dtype."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = _div127(torch.clamp(amax, min=1e-8))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[k, n] -> (int8 [k, n], fp32 scales [1, n]); symmetric per column, in w's dtype."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = _div127(torch.clamp(amax, min=1e-8))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An nn.Linear weight [n, k] -> (w_q int8 [n, k], w_scale fp32 [n]),
    quantized per output channel from the weight upcast to fp32."""
    w_q, w_scale = quantize_rows(weight.detach().float())
    return w_q, w_scale[:, 0].contiguous()


def int8_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """Kernel G's function.  The int32 sum is exact through an fp64 product
    of the int8 values (|sum| < 2^31 < 2^53); PyTorch's int8 matmul would
    wrap in int8, and CUDA has no int32 matmul."""
    acc = (x_q.double() @ w_q.double().t()).to(torch.int32)
    return acc.float() * x_scale * w_scale


def _check(x_q, x_scale, w_q, w_scale):
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul takes x_q [m, k] and w_q [n, k], got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 x_q and w_q, got {x_q.dtype}, {w_q.dtype}")
    if x_scale.shape != (m, 1) or w_scale.shape != (n,) or x_scale.dtype != torch.float32 \
            or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul takes fp32 x_scale [{m}, 1] and w_scale [{n}], got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}, "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    _check_operands("int8_matmul", x_q.device, x_q=x_q, x_scale=x_scale, w_q=w_q,
                    w_scale=w_scale)
    _check_sizes("int8_matmul", m, n, k)


def _check_operands(who, device, **tensors):
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who} needs a contiguous, 16-byte aligned {name}")
        if t.device != device:
            raise ValueError(f"{who}: {name} is on {t.device}, not {device}")


def _check_sizes(who, m, n, k):
    if k > K_MAX:
        raise ValueError(f"{who}: k = {k} > {K_MAX} could overflow the int32 sum")
    if k == 0 or max(m, n, k) >= 2**31 or _tiles(m, n) * SPLIT_MAX >= 2**31:
        raise ValueError(f"{who}: m = {m}, n = {n}, k = {k} outside what the kernel takes")


def _tiles(m: int, n: int) -> int:
    return -(-m // TILE_M) * -(-n // TILE_N)


@functools.lru_cache(maxsize=4096)
def split_k(m: int, n: int, k: int, sms: int) -> int:
    """Kernel G's split of k: as many splits as leave no SM idle while the
    [m, n] output has fewer 128 x 256 tiles than ``sms`` SMs, at most
    ``SPLIT_MAX``, each at least ``SPLIT_MIN_STEPS`` 128-wide k steps (a
    split's partial tile goes through L2 and back, which shorter splits do
    not repay on the H100), rebalanced so none is empty."""
    steps = -(-k // TILE_K)
    s = max(1, min(sms // _tiles(m, n), steps // SPLIT_MIN_STEPS, SPLIT_MAX))
    return -(-steps // -(-steps // s))


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sync(device: torch.device, tiles: int) -> int:
    """The address of the cross-block words (zeroed, and left so by every
    launch): the grid barrier's at 0, a split tile's arrival counter after
    it, shared with kernel I on the stream."""
    return workspace(device, "sync", 4 * (1 + tiles), zero=True).data_ptr()


def _align(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def int8_matmul_cuda(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, splits: int | None = None) -> torch.Tensor:
    """Launch kernel G's TPU-function instance on PyTorch's current stream:
    fp32 [m, n].  ``splits``: the k split (default ``split_k``)."""
    _check(x_q, x_scale, w_q, w_scale)
    m, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    dev = x_q.device
    splits = splits or split_k(m, n, k, _sms(dev))
    tiles = _tiles(m, n)
    part = (workspace(dev, "G scratch", tiles * splits * TILE_M * TILE_N * 4)
            if splits > 1 else None)
    KERNEL.launch(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                  out.data_ptr(), _ptr(part), _sync(dev, tiles), m, n, k, splits, _stream(dev))
    return out


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q int8 [m, k], x_scale fp32 [m, 1], w_q int8 [n, k], w_scale fp32
    [n] -> fp32 [m, n].  Device dispatch of kernel G's TPU-function
    instance: the plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale)
    if x_q.device.type == "cuda":
        return int8_matmul_cuda(x_q, x_scale, w_q, w_scale)
    raise ValueError(f"int8_matmul: no implementation for device {x_q.device}")


def linear_w8a8_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """The quantized linear of JAX ``layers.linear``: rows of x quantized
    on the fly in x's dtype, the int8 product, the cast to x's dtype, then
    the bias."""
    shp = x.shape
    x_q, x_scale = quantize_rows(x.reshape(-1, shp[-1]))
    y = int8_matmul_plain(x_q, x_scale, w_q, w_scale).reshape(*shp[:-1], -1).to(x.dtype)
    return y if bias is None else y + bias


def linear_w8a8_cuda(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor | None = None, splits: int | None = None,
                     launches: int = 1) -> torch.Tensor:
    """Launch kernel G's serving instance on PyTorch's current stream: x
    [..., k] bf16 or fp32 -> [..., n] in x's dtype.  ``launches=2`` runs
    the row quantization and the product as two launches of the same
    kernel (a yardstick for the one-launch form, which serving uses)."""
    shp = x.shape
    k = shp[-1]
    x2 = x.reshape(-1, k)
    m, n = x2.shape[0], w_q.shape[0]
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"linear_w8a8 kernel takes bf16 or fp32 x, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[1] != k:
        raise ValueError(f"linear_w8a8 takes int8 w_q [n, {k}], got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (n,):
        raise ValueError(f"linear_w8a8 takes fp32 w_scale [{n}], got {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    if bias is not None and (bias.dtype != x.dtype or bias.shape != (n,)):
        raise ValueError(f"linear_w8a8 takes a bias [{n}] of x's dtype {x.dtype}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if launches not in (1, 2):
        raise ValueError(f"linear_w8a8: launches is 1 or 2, got {launches}")
    dev = x.device
    if bias is None:
        _check_operands("linear_w8a8", dev, x=x2, w_q=w_q, w_scale=w_scale)
    else:
        _check_operands("linear_w8a8", dev, x=x2, w_q=w_q, w_scale=w_scale, bias=bias)
    _check_sizes("linear_w8a8", m, n, k)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out.reshape(*shp[:-1], n)
    splits = splits or split_k(m, n, k, _sms(dev))
    tiles = _tiles(m, n)
    xq_bytes, xs_bytes = _align(m * k), _align(4 * m)
    scratch = workspace(dev, "G scratch",
                        xq_bytes + xs_bytes + tiles * splits * TILE_M * TILE_N * 4)
    x_q = scratch.data_ptr()
    part = x_q + xq_bytes + xs_bytes if splits > 1 else None
    sync, stream = _sync(dev, tiles), _stream(dev)
    for phases in ((3,) if launches == 1 else (1, 2)):
        KERNEL_LINEAR.launch(x2.data_ptr(), code, x_q, x_q + xq_bytes, w_q.data_ptr(),
                             w_scale.data_ptr(), _ptr(bias), out.data_ptr(), part, sync, m, n,
                             k, splits, phases, stream)
    return out.reshape(*shp[:-1], n)


def quantize_rows_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's row phase alone (one launch of the serving instance with
    the product off): ``quantize_rows`` of a bf16 or fp32 x [m, k] on the
    card, as the serving linear quantizes its input."""
    if x.ndim != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantize_rows_cuda takes bf16 or fp32 x [m, k], got {x.dtype} "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    _check_operands("quantize_rows_cuda", x.device, x=x)
    _check_sizes("quantize_rows_cuda", m, 1, k)
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        KERNEL_LINEAR.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], x_q.data_ptr(),
                             x_scale.data_ptr(), None, None, None, None, None,
                             _sync(x.device, 0), m, 1, k, 1, 1,
                             _stream(x.device))
    return x_q, x_scale


def linear_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """JAX ``layers.linear``'s ``kernel_q`` branch.  Device dispatch of
    kernel G's serving instance: the plain composition for CPU tensors,
    one launch for CUDA tensors."""
    if x.device.type == "cpu":
        return linear_w8a8_plain(x, w_q, w_scale, bias)
    if x.device.type == "cuda":
        return linear_w8a8_cuda(x, w_q, w_scale, bias)
    raise ValueError(f"linear_w8a8: no implementation for device {x.device}")


def quantized_linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """JAX ``quantized_linear``: [m, k] @ [k, n] with both operands
    quantized on the fly; fp32 [m, n].  A test form: serving quantizes the
    weights once."""
    x_q, x_scale = quantize_rows(x)
    w_q, w_scale = quantize_cols(w)
    y = int8_matmul(x_q, x_scale, w_q.t().contiguous(), w_scale[0].contiguous())
    return y if bias is None else y + bias


# ------------------------------------------------------------ serving wiring

def quantize_linear_params(module: nn.Module, weight: str = "weight") -> None:
    """JAX ``quantize_linear_params`` on a module: quantizes ``module.<weight>``
    [n, k] into the non-persistent buffers ``<weight>_q`` (int8 [n, k]) and
    ``w_scale`` (``qkv_w_scale`` for the fused ``qkv_weight``), fp32 [n].
    The dense weight and the state dict stay as they are."""
    w_q, w_scale = quantize_weight(getattr(module, weight))
    module.register_buffer(f"{weight}_q", w_q, persistent=False)
    module.register_buffer(weight.replace("weight", "w_scale"), w_scale, persistent=False)


def holds_w8a8(model: nn.Module) -> bool:
    """Whether ``quantize_dit_blocks`` has quantized a linear of ``model``."""
    return any(getattr(mod, name, None) is not None for mod in model.modules()
               for name in ("weight_q", "qkv_weight_q"))


def quantize_dit_blocks(model: nn.Module, arch_cfg) -> list[str]:
    """W8A8-quantize a backbone's block linears in place, as JAX
    ``quantize_dit_blocks`` does its parameter tree; returns the quantized
    weights' names.  Which linears depends on the backbone
    (``backbones.quantize_targets``): DiT's fused qkv (or q, k, v),
    ``to_out`` and both feed-forward linears in every block; MMDiT's
    x-stream q, k, v and ``to_out`` in every block but the last; UNetT
    raises ``ValueError``.  Call after the model's cast to the compute dtype
    and its qkv fusion."""
    from f5_tts_tpu_torch.models.backbones import quantize_targets

    names = []
    for name, module, weight in quantize_targets(model, arch_cfg):
        quantize_linear_params(module, weight)
        names.append(name)
    return names
