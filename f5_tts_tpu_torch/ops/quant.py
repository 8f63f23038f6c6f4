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
[1, n].  [n, k] is the layout mma.sync's col-major B operand reads with one
32-bit load per register (``ldmatrix.trans`` does not take 8-bit elements).
``quantize_cols`` keeps JAX's [k, n] signature for the tests.

Numerics, as JAX: activations are quantized in their own dtype (bf16 on the
card): the row max, the scale ``max(amax, 1e-8) / 127`` and ``x / scale``
are each rounded to x's dtype, rounded half to even, clipped to +-127, and
only the scale is then cast to fp32.  Weights are quantized from the
compute-dtype weights upcast to fp32, as the JAX engine does
(``infer/engine.py:234-241``: fuse, cast, quantize).  The product is
``float(int32 sum) * x_scale * w_scale`` in fp32, in that order; the linear
casts it to x's dtype and only then adds the bias.

Dispatch is by device: a CPU tensor runs ``int8_matmul_plain``; a CUDA tensor
launches kernel G (``csrc/int8_matmul.cu``), and anything it does not take
raises.  ``KERNEL.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("int8_matmul", "int8_matmul.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _P])
K_MAX = 2**31 // 127**2  # the longest k whose int32 sum cannot overflow


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[m, k] -> (int8 [m, k], fp32 scales [m, 1]); symmetric per row, in x's dtype."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[k, n] -> (int8 [k, n], fp32 scales [1, n]); symmetric per column, in w's dtype."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
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
    for name, t in (("x_q", x_q), ("x_scale", x_scale), ("w_q", w_q), ("w_scale", w_scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul needs a contiguous, 16-byte aligned {name}")
        if t.device != x_q.device:
            raise ValueError(f"{name} is on {t.device}, x_q on {x_q.device}")
    if k > K_MAX:
        raise ValueError(f"int8_matmul: k = {k} > {K_MAX} could overflow the int32 sum")
    if -(-m // 64) > 65535 or max(m, n) >= 2**31:
        raise ValueError(f"int8_matmul: m = {m}, n = {n} exceed the kernel grid")


def int8_matmul_cuda(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """Launch kernel G on PyTorch's current stream: fp32 [m, n]."""
    _check(x_q, x_scale, w_q, w_scale)
    m, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    KERNEL.launch(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                  out.data_ptr(), m, n, k, torch.cuda.current_stream(x_q.device).cuda_stream)
    return out


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q int8 [m, k], x_scale fp32 [m, 1], w_q int8 [n, k], w_scale fp32
    [n] -> fp32 [m, n].  Device dispatch of kernel G: the plain version for
    CPU tensors."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale)
    if x_q.device.type == "cuda":
        return int8_matmul_cuda(x_q, x_scale, w_q, w_scale)
    raise ValueError(f"int8_matmul: no implementation for device {x_q.device}")


def linear_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """The quantized linear of JAX ``layers.linear``: rows of x quantized
    on the fly in x's dtype, the int8 product, the cast to x's dtype, then
    the bias."""
    shp = x.shape
    x_q, x_scale = quantize_rows(x.reshape(-1, shp[-1]))
    y = int8_matmul(x_q, x_scale, w_q, w_scale).reshape(*shp[:-1], -1).to(x.dtype)
    return y if bias is None else y + bias


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
