"""The rotary and layout op from the fused qkv projection to q, k, v
(``ops/rope.py`` ``rope_qkv``) and ``layers.mha``'s gate to it, on the CPU.

The op's CPU implementation must equal the composition ``mha`` ran before
it (chunk, head split, ``apply_rotary`` on the first ``rot_heads`` heads)
bitwise, and ``mha`` through the op must equal ``mha`` without it bitwise.
The CUDA kernel is checked on the card (``tests/test_torch_cuda.py``).
``mha`` sends a projection to the op only for a CUDA tensor; these tests
run the real gate on a CPU tensor taken as a CUDA one (``gate``) to drive
the gate and the op's CPU implementation through ``mha``, and count the
op's calls for whether it was taken.  Shapes: F5TTS_v1_Base's block (16 heads of 64, every head
rotated), E2TTS_Base's (UNetT: head 0 rotated, n + 1 frames with the time
token), F5TTS_v1_Small's (12 heads) and a W8A8 projection (``linear_w8a8``'s
plain version), at small batches and lengths.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import pytest
import torch

from f5_tts_tpu_torch.models import layers as L
from f5_tts_tpu_torch.ops import quant as Q
from f5_tts_tpu_torch.ops import rope as R

CPU = torch.device("cpu")


def _attention(heads: int, w8a8: bool = False, qk_norm=None, fused: bool = True, seed: int = 0,
               dim_head: int = 64):
    torch.manual_seed(seed)
    a = L.Attention(heads * dim_head, heads, dim_head, qk_norm=qk_norm)
    if fused:
        a.fuse_qkv()
    a = a.to(torch.bfloat16).requires_grad_(False)
    if w8a8:
        Q.quantize_linear_params(a, "qkv_weight")
    return a


def _tables(n: int, dim_head: int = 64, dtype=torch.bfloat16):
    """The angles and the cos / sin rows [0, n) as a backbone passes them."""
    return (R.device_table("rope", 4096, dim_head, CPU)[:n],
            [t[:n] for t in R.cos_sin_tables(4096, dim_head, CPU, dtype)])


def _inputs(n: int, dim: int, b: int = 2, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, dim), generator=g).to(torch.bfloat16)
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[-1, n - n // 3:] = False
    return (x, mask, *_tables(n))


def _old_composition(qkv, freqs, heads, rot_heads):
    """``mha``'s rotary and layout before the op, as it was written."""
    b, n, _ = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(b, n, heads, -1).transpose(1, 2)
    k = k.reshape(b, n, heads, -1).transpose(1, 2)
    v = v.reshape(b, n, heads, -1).transpose(1, 2)
    if rot_heads == heads:
        return R.apply_rotary(q, freqs), R.apply_rotary(k, freqs), v
    q = torch.cat([R.apply_rotary(q[:, :rot_heads], freqs), q[:, rot_heads:]], dim=1)
    k = torch.cat([R.apply_rotary(k[:, :rot_heads], freqs), k[:, rot_heads:]], dim=1)
    return q, k, v


class _OnCard:
    """A tensor as ``rope_qkv_takes`` would see it on the card."""
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


class _Gate:
    """``mha``'s gate, the real ``rope_qkv_takes`` with CPU tensors taken as
    CUDA ones while ``on``, and the op's calls through ``mha`` counted."""

    def __init__(self, monkeypatch):
        self.calls, self.on = 0, True
        takes, op = R.rope_qkv_takes, R.rope_qkv

        def gate(qkv, heads, backend):
            return takes(_OnCard(qkv) if self.on else qkv, heads, backend)

        def counted(*args):
            self.calls += 1
            return op(*args)

        monkeypatch.setattr(L, "rope_qkv_takes", gate)
        monkeypatch.setattr(L, "rope_qkv", counted)


@pytest.fixture
def gate(monkeypatch):
    return _Gate(monkeypatch)


# (heads, rot_heads, n, w8a8): F5TTS_v1_Base, E2TTS_Base (odd n: UNetT's
# n + 1), F5TTS_v1_Small, the W8A8 projection, F5TTS_Base's pe_attn_head 1
SHAPES = {"f5_base": (16, 16, 64, False), "e2_base": (16, 1, 65, False),
          "f5_small": (12, 12, 33, False), "w8a8": (16, 16, 48, True),
          "f5_v0_base": (16, 1, 40, True)}


@pytest.mark.parametrize("case", list(SHAPES))
def test_op_cpu_equals_the_old_composition_bitwise(case):
    heads, rot, n, w8a8 = SHAPES[case]
    a = _attention(heads, w8a8)
    x, _, freqs, (cos, sin) = _inputs(n, heads * 64)
    qkv = (Q.linear_w8a8(x, a.qkv_weight_q, a.qkv_w_scale, a.qkv_bias) if w8a8 else
           torch.nn.functional.linear(x, a.qkv_weight, a.qkv_bias))
    got = R.rope_qkv(qkv, cos, sin, heads, rot)
    want = _old_composition(qkv, freqs, heads, rot)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == (2, heads, n, 64) and g.dtype == torch.bfloat16
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", list(SHAPES))
def test_mha_through_the_op_equals_mha_without_it(gate, case):
    heads, rot, n, w8a8 = SHAPES[case]
    a = _attention(heads, w8a8)
    x, mask, freqs, cos_sin = _inputs(n, heads * 64)
    pe = None if rot == heads else rot
    got = L.mha(a, x, heads, mask=mask, rope_freqs=freqs, pe_attn_head=pe, rope_cos_sin=cos_sin)
    assert gate.calls == 1
    gate.on = False
    want = L.mha(a, x, heads, mask=mask, rope_freqs=freqs, pe_attn_head=pe, rope_cos_sin=cos_sin)
    assert gate.calls == 1
    assert torch.equal(got, want)


class _OneRankTP:
    """A ``TensorParallel`` of one rank, with no process group."""
    size, rank = 1, 0

    def copy_in(self, x):
        return x

    def reduce(self, x):
        return x

    def local_heads(self, heads):
        return heads


def _ring(q, k, v, mask):
    return L.attention(q, k, v, mask=mask, backend="sdpa")


# (what differs from the taken case, whether the op is taken)
GATE = {
    "taken": ({}, True),
    "flash": ({"backend": "flash"}, True),
    "w8a8": ({"w8a8": True}, True),
    "pe_attn_head": ({"pe": 1}, True),
    "grad_on_x": ({"grad_x": True}, False),
    "grad_on_weights": ({"grad_w": True}, False),
    "no_grad_mode": ({"grad_x": True, "no_grad": True}, True),
    "tensor_parallel": ({"tp": True}, False),
    "qk_norm": ({"qk_norm": "rms_norm"}, False),
    "callable_backend": ({"backend": _ring}, False),
    "sdpa": ({"backend": "sdpa"}, False),
    "chunked": ({"backend": "chunked"}, False),
    "train_auto": ({"backend": "train_auto"}, False),
    "flash_train": ({"backend": "flash_train"}, False),
    "fp32": ({"dtype": torch.float32}, False),
    "unfused": ({"fused": False}, False),
    "no_rope": ({"rope": False}, False),
    "no_tables": ({"tables": False}, False),
    "head_width_32": ({"dim_head": 32}, False),
}


@pytest.mark.parametrize("case", list(GATE))
def test_mha_gate(gate, case):
    """The op is taken only for a fused projection with no tensor
    parallelism and no qk-norm, the rotary tables given, a bf16 tensor,
    64-wide heads, backend "auto" or "flash", and no gradient to carry;
    every other case keeps the old path.  Either way the output is the old
    path's."""
    kw, taken = GATE[case]
    heads, n = 4, 24
    a = _attention(heads, kw.get("w8a8", False), kw.get("qk_norm"), kw.get("fused", True),
                   dim_head=kw.get("dim_head", 64))
    dtype = kw.get("dtype", torch.bfloat16)
    a = a.to(dtype)
    if kw.get("tp"):
        a.tp = _OneRankTP()
    if kw.get("grad_w"):
        a.qkv_weight.requires_grad_(True)
    x, mask, _, _ = _inputs(n, heads * kw.get("dim_head", 64))
    freqs, cos_sin = _tables(n, kw.get("dim_head", 64))
    x = x.to(dtype).requires_grad_(kw.get("grad_x", False))
    rope = kw.get("rope", True)
    args = dict(mask=mask, rope_freqs=freqs if rope else None,
                rope_cos_sin=cos_sin if rope and kw.get("tables", True) else None,
                pe_attn_head=kw.get("pe"), backend=kw.get("backend", "auto"))
    with torch.set_grad_enabled(not kw.get("no_grad", False)):
        got = L.mha(a, x, heads, **args)
        assert gate.calls == int(taken)
    gate.on = False
    with torch.no_grad():
        want = L.mha(a, x, heads, **args)
    assert torch.equal(got.detach(), want)


class _OpOnly(torch.nn.Module):
    def __init__(self, heads, rot_heads):
        super().__init__()
        self.heads, self.rot_heads = heads, rot_heads

    def forward(self, qkv, cos, sin):
        return R.rope_qkv(qkv, cos, sin, self.heads, self.rot_heads)


class _Mha(torch.nn.Module):
    def __init__(self, attn, heads, pe):
        super().__init__()
        self.attn, self.heads, self.pe = attn, heads, pe

    def forward(self, x, mask, freqs, cos, sin):
        return L.mha(self.attn, x, self.heads, mask=mask, rope_freqs=freqs, pe_attn_head=self.pe,
                     rope_cos_sin=(cos, sin))


def _op_nodes(ep):
    return [nd for nd in ep.graph.nodes
            if nd.op == "call_function" and "rope_qkv" in str(nd.target)]


@pytest.mark.parametrize("heads,rot,n", [(16, 16, 64), (16, 1, 65), (12, 12, 33)])
def test_fake_implementation_under_export(heads, rot, n):
    """``torch.export`` keeps the op as one node, and its fake
    implementation gives the outputs' shapes and dtype."""
    qkv = torch.randn((2, n, 3 * heads * 64)).to(torch.bfloat16)
    _, (cos, sin) = _tables(n)
    ep = torch.export.export(_OpOnly(heads, rot), (qkv, cos.clone(), sin.clone()), strict=False)
    nodes = _op_nodes(ep)
    assert len(nodes) == 1
    for val in nodes[0].meta["val"]:
        assert tuple(val.shape) == (2, heads, n, 64) and val.dtype == torch.bfloat16
    got = ep.module()(qkv, cos, sin)
    for g, w in zip(got, R.rope_qkv_plain(qkv, cos, sin, heads, rot)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pe", [None, 1])
def test_mha_exports_with_one_op(gate, pe):
    """An exported ``mha`` (as an AOT bundle's step holds it) takes the op
    once, and runs as the live ``mha`` does."""
    heads, n = 4, 24
    a = _attention(heads)
    x, mask, freqs, (cos, sin) = _inputs(n, heads * 64)
    with torch.no_grad():
        ep = torch.export.export(_Mha(a, heads, pe), (x, mask, freqs.clone(), cos.clone(),
                                                      sin.clone()), strict=False)
        assert len(_op_nodes(ep)) == 1
        got = ep.module()(x, mask, freqs, cos, sin)
        want = L.mha(a, x, heads, mask=mask, rope_freqs=freqs, pe_attn_head=pe,
                     rope_cos_sin=(cos, sin))
    assert torch.equal(got, want)


def test_cos_sin_tables_are_made_once_per_table(monkeypatch):
    """One cos / sin pair per rope table and dtype (graphs read it by
    address), rounded as ``apply_rotary`` rounds them; a DiT and a UNetT
    forward pass slices of it down to ``mha``."""
    from f5_tts_tpu_torch.models import dit, unett
    from f5_tts_tpu_torch.models.configs import DiTConfig, UNetTConfig

    table = R.device_table("rope", 4096, 64, CPU)
    c1, s1 = R.cos_sin_tables(4096, 64, CPU, torch.bfloat16)
    c2, s2 = R.cos_sin_tables(4096, 64, CPU, torch.bfloat16)
    assert c1 is c2 and s1 is s2
    assert torch.equal(c1, torch.cos(table).to(torch.bfloat16))
    assert torch.equal(s1, torch.sin(table).to(torch.bfloat16))
    seen = []
    mha = L.mha

    def spy(*args, rope_cos_sin=None, **kw):
        seen.append(rope_cos_sin)
        return mha(*args, rope_cos_sin=rope_cos_sin, **kw)

    monkeypatch.setattr(L, "mha", spy)
    for mod, arch in ((dit, DiTConfig(dim=128, depth=1, heads=2, text_dim=32, conv_layers=1)),
                      (unett, UNetTConfig(dim=128, depth=2, heads=2))):
        model = (mod.DiT if mod is dit else mod.UNetT)(arch).to(torch.bfloat16)
        n = 12
        x = torch.zeros((1, n, arch.mel_dim), dtype=torch.bfloat16)
        seen.clear()
        with torch.no_grad():
            mod.forward_with_text(model, arch, x, x, torch.zeros((1, n), dtype=torch.long),
                                  torch.tensor(0.5))
        rows = n + (mod is unett)  # UNetT's time token
        horizon = arch.max_pos + (mod is unett)
        want = R.cos_sin_tables(horizon, arch.dim_head, CPU, torch.bfloat16)
        assert len(seen) == arch.depth
        for cs in seen:
            for got, whole in zip(cs, want):
                assert got.data_ptr() == whole.data_ptr() and got.shape == (rows, arch.dim_head)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The CUDA implementation checks its input before any launch."""
    qkv = torch.zeros((1, 4, 3 * 2 * 64), dtype=torch.bfloat16)
    cos = sin = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        R.rope_qkv_cuda(qkv, cos, sin, 2, 2)  # a CPU tensor
    with pytest.raises(ValueError):  # the fake implementation serves tracing, not meta calls
        R.rope_qkv(qkv.to("meta"), cos.to("meta"), sin.to("meta"), 2, 2)


# (backbone, EngineOptions): every engine path whose blocks run mha
ENGINES = {"dit": ("dit", {}), "dit_w8a8": ("dit", {"quantize": True}),
           "dit_picard": ("dit", {"time_parallel_window": 2, "picard_tol": 0.0}),
           "unett": ("unett", {})}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_calls_through_the_op_equal_the_plain_path(gate, case):
    """A bf16 engine call (sequential, W8A8, Picard; DiT and UNetT) gives
    bitwise the same mel through the op as without it, and sends every
    block's projection of every forward to it."""
    import numpy as np

    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig, UNetTConfig

    backbone, opts = ENGINES[case]
    arch = (DiTConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1) if backbone == "dit"
            else UNetTConfig(dim=256, depth=2, heads=4))
    torch.manual_seed(0)
    cfm = CFM(arch)
    randomize_zero_init(cfm.transformer, torch.Generator().manual_seed(1))
    cfg = ModelConfig(name="narrow", arch=arch, tokenizer="char")
    eng = InferenceEngine(cfm, cfg, vocoder=None, dtype=torch.bfloat16,
                          options=EngineOptions(nfe_step=4, **opts))
    req = ([np.zeros((60, 100), np.float32)], [np.arange(20, dtype=np.int32)], [200])
    gate.on = False
    want = eng.generate_batch(*req, seeds=[3], decode=False)[0]
    assert gate.calls == 0
    gate.on = True
    got = eng.generate_batch(*req, seeds=[3], decode=False)[0]
    # one batched forward per step, or per Picard sweep over its window
    forwards = eng.last_sweeps if opts.get("time_parallel_window") else 4
    assert gate.calls == arch.depth * forwards
    np.testing.assert_array_equal(got, want)
