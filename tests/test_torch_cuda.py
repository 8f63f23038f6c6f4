"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode; a CPU tensor runs the plain version instead).  The file imports
no JAX, so it runs on the GPU machine, where the repository's conftest
(which configures JAX) is skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: bf16 inputs, and the kernels round to bf16 where the TPU
kernels do, against plain versions computed in fp32 on the same values.
The backward kernels round do, p and ds to bf16 as well; their gradients
are compared relative to the largest reference value (2e-2 max, 4e-3 mean).
The two-segment instances (kernel F, and C, D, E with ``seg``) are held to
the same tolerances, at a segment boundary inside a 64-key tile, an odd
length, and rows with an empty text segment or no valid key at all.  D and
E stream 64-row tiles in blocks of up to 128 rows: their cases include
n = 1, 127, 129 and 1000, valid prefixes and segments that end on a tile
edge beside ones that end inside a tile, and a determinism check (two
launches, bitwise-equal dq, dk, dv, in every configuration built).
Kernel G (the W8A8 int8 product) must equal its plain version bitwise (and
so within 1e-6 relative: the int32 sum is exact), at the serving shapes,
m = 1 and 4096 and ragged m, k, n; its serving instance (quantization,
product, cast and bias in one launch) must equal the plain composition on
the card bitwise in bf16 and fp32 (a row holding a NaN: a NaN scale and
output row on both sides), and a W8A8 linear on the card must launch it.
Its workspaces (``ops/workspace.py``) are per stream: launches on two
streams at once stay bitwise, and a buffer a CUDA graph captured is never
freed under the graph (a larger call on its stream raises).
Kernels H (pipelined flash attention, every instance, with ragged n, lens
of 0, a length across a tile edge and b*h = 128; bitwise across two
launches, in a CUDA-graph replay and on two streams at once) and I (fused
LayerNorm-modulate matmul, K up to 4096 and ragged) are held as kernel A:
2e-2 max, 2e-3 mean error, I's relative to the largest reference value.
A block waiting on an mbarrier that never completes must trap within
seconds (in a child process), not hang.  The forward
kernels A, C, F and kernel B (ConvPositionEmbedding) are checked in every
configuration built (``FWD_CONFIGS``, ``fused_convpos.CONFIGS``) at
n = 1, 63, 65, 127, 129, lengths of 0 and lengths that end on a tile edge
beside ones that end inside a tile, with a two-launch bitwise determinism
check; B's fp32 instance (three bf16 products) against the fp32 plain
version, TF32 off, to 1e-4 relative to the largest reference value.
The serving engine's CUDA graphs (a narrow DiT, dense and W8A8): a replay
equals the module-level eager function bitwise, N replays count N eager
calls' launches of A, B and G, and two threads replaying one engine get
each request's own rows, bitwise.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import numpy as np
import pytest
import torch

from f5_tts_tpu_torch.ops import flash_attention as FA
from f5_tts_tpu_torch.ops import fused_convpos as FC
from f5_tts_tpu_torch.ops import quant as Q
from f5_tts_tpu_torch.scripts import exp_fused_ln_matmul as XI
from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,lens", [(200, [200, 163]), (1000, [0, 963]), (65, [65, 1]),
                                    (1, [1, 0]), (63, [63, 17]), (127, [127, 64]),
                                    (129, [129, 128]), (256, [256, 192])])
def test_flash_kernel_matches_plain(gen, n, lens):
    q, k, v = (torch.randn((2, 16, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = FA.KERNEL.launches
    got = FA.flash_attention(q, k, v, lens_t).float()
    assert FA.KERNEL.launches == before + 1
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens_t)
    err = (got - want).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    if 0 in lens:
        assert torch.all(got[lens.index(0)] == 0)


FWD_CASES = [  # (n, lens or (lens_a, lens_t), seg)
    (1, [1, 0], None), (63, [63, 17], None), (65, [65, 64], None), (127, [127, 0], None),
    (129, [129, 128], None), (384, [384, 131], None),
    (300, ([256, 0], [44, 0]), 256),     # seg and a segment end on tile edges; row 1 empty
    (700, ([600, 333], [100, 77]), 600), # seg inside a tile
]


@pytest.mark.parametrize("n,lens,seg", FWD_CASES)
def test_forward_kernels_every_config_deterministic(gen, n, lens, seg):
    """Kernels A, C (and F, C two-segment with seg) in every configuration
    built: within tolerance of the plain version, the zero-row rule, C's o
    equal to A's bit for bit, and two launches bitwise equal."""
    q, k, v = (torch.randn((2, 4, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if seg is not None:
        lt = lt.T.contiguous()
    o_ref, L_ref = FA.flash_attention_fwd_stats_plain(q, k, v, lt, seg)
    empty = ~FA.key_valid(lt, n, seg).any(dim=1)
    for cfg in FA.FWD_CONFIGS:
        oa = FA.flash_attention_cuda(q, k, v, lt, seg, config=cfg)
        oc, L = FA.flash_attention_fwd_stats_cuda(q, k, v, lt, seg, config=cfg)
        again = FA.flash_attention_cuda(q, k, v, lt, seg, config=cfg)
        err = (oa.float() - o_ref.float()).abs()
        assert err.max().item() < 2e-2 and err.mean().item() < 2e-3, cfg
        assert (L - L_ref).abs().max().item() < 1e-2, cfg
        assert torch.equal(oa, oc) and torch.equal(oa, again), cfg
        assert torch.all(oa[empty] == 0) and torch.all(L[empty] == FA.NO_KEY_LSE), cfg


def test_flash_kernel_takes_fp32_and_rejects_other_head_dims(gen):
    q = torch.randn((1, 2, 100, 64), generator=gen, device="cuda")
    lens = torch.tensor([70], dtype=torch.int32, device="cuda")
    got = FA.flash_attention(q, q, q, lens)
    assert got.dtype == torch.float32
    assert (got - FA.flash_attention_plain(q, q, q, lens)).abs().max().item() < 2e-2
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                           q[..., :32].contiguous(), lens)


def _convpos_weights(gen, d=1024):
    bound = (64 * 31) ** -0.5
    w1, w2 = ((torch.rand((d, 64, 31), generator=gen, device="cuda") * 2 - 1) * bound
              for _ in range(2))
    b1, b2 = ((torch.rand((d,), generator=gen, device="cuda") * 2 - 1) * bound for _ in range(2))
    return w1, b1, w2, b2


@pytest.mark.parametrize("n", [1, 300, 63, 65, 127, 129, 1024])
def test_convpos_kernel_matches_plain(gen, n):
    d, groups = 1024, 16
    w1, b1, w2, b2 = _convpos_weights(gen, d)
    x = torch.randn((2, n, d), generator=gen, device="cuda")
    args = [t.to(torch.bfloat16) for t in (x, w1, b1, w2, b2)]
    lens = torch.tensor([n, max(n - 37, 0)], dtype=torch.int32, device="cuda")
    before = FC.KERNEL.launches
    got = FC.conv_pos_fused(*args, lens, groups=groups).float()
    assert FC.KERNEL.launches == before + 1
    want = FC.conv_pos_plain(*[a.float() for a in args], lens, groups)
    err = (got - want).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3


@pytest.mark.parametrize("n,lens", [(129, [129, 0]), (256, [256, 128]), (300, [0, 0]),
                                    (200, [192, 64])])
def test_convpos_kernel_every_config_deterministic(gen, n, lens):
    """Kernel B in every configuration built, with lengths of 0 and lengths
    that end on a row-tile edge: within tolerance, zero rows past len, and
    two launches bitwise equal."""
    w1, b1, w2, b2 = (t.to(torch.bfloat16) for t in _convpos_weights(gen))
    x = torch.randn((2, n, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = FC.conv_pos_plain(*(t.float() for t in (x, w1, b1, w2, b2)), lt, 16)
    for cfg in FC.CONFIGS:
        got = FC.conv_pos_cuda(x, w1, b1, w2, b2, lt, 16, config=cfg)
        assert torch.equal(got, FC.conv_pos_cuda(x, w1, b1, w2, b2, lt, 16, config=cfg)), cfg
        err = (got.float() - want).abs()
        assert err.max().item() < 2e-2 and err.mean().item() < 2e-3, cfg
        for i, ln in enumerate(lens):
            assert torch.all(got[i, ln:] == 0), cfg


def test_convpos_fp32_instance_keeps_fp32_accuracy(gen):
    """fp32 x and weights: the kernel's three bf16 products per tap against
    the fp32 plain version with TF32 off, in every configuration."""
    w1, b1, w2, b2 = _convpos_weights(gen)
    x = torch.randn((2, 333, 1024), generator=gen, device="cuda")
    lt = torch.tensor([333, 250], dtype=torch.int32, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = FC.conv_pos_plain(x, w1, b1, w2, b2, lt, 16)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for cfg in FC.CONFIGS:
        got = FC.conv_pos_cuda(x, w1, b1, w2, b2, lt, 16, config=cfg)
        assert got.dtype == torch.float32
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < 1e-4, (cfg, rel)


def test_convpos_kernel_rejects_other_group_widths(gen):
    x = torch.zeros((1, 8, 64), device="cuda")
    w = torch.zeros((64, 4, 31), device="cuda")
    b = torch.zeros((64,), device="cuda")
    with pytest.raises(ValueError, match="64-channel groups"):
        FC.conv_pos_fused(x, w, b, w, b, torch.tensor([8], dtype=torch.int32, device="cuda"),
                          groups=16)


def _rel(got, want):
    got, want = got.float(), want.float()
    scale = want.abs().max().clamp(min=1e-6)
    err = (got - want).abs() / scale
    return err.max().item(), err.mean().item()


def _train_inputs(gen, n, lens, b=2, h=4, dtype=torch.bfloat16):
    q, k, v, do = (torch.randn((b, h, n, 64), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    return q, k, v, do, torch.tensor(lens, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("n,lens", [(256, [256, 219]), (200, [0, 163]), (65, [65, 1]),
                                    (1, [1, 0]), (127, [127, 64]), (129, [129, 128]),
                                    (1000, [1000, 937]), (384, [128, 200])])
def test_flash_train_kernels_match_plain(gen, n, lens):
    """Kernels C, D and E against their plain versions on the same inputs."""
    q, k, v, do, lens_t = _train_inputs(gen, n, lens)
    c0, d0, e0 = FA.KERNEL_STATS.launches, FA.KERNEL_DQ.launches, FA.KERNEL_DKV.launches
    o, L = FA.flash_attention_fwd_stats(q, k, v, lens_t)
    o_ref, L_ref = FA.flash_attention_fwd_stats_plain(q, k, v, lens_t)
    err = (o.float() - o_ref.float()).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    assert (L - L_ref).abs().max().item() < 1e-2  # log2-domain scores of bf16-rounded q
    D = (do.float() * o.float()).sum(-1).contiguous()
    if n == 1:
        # softmax over one key is constant: dq = dk = 0 up to rounding, so
        # shift D by a logsumexp cotangent (flash_attention_with_stats's
        # backward) to give the q and k gradients something to hold
        D = (D - torch.randn(D.shape, generator=gen, device="cuda")).contiguous()
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, do, L, D, lens_t)
    ref = FA.flash_attention_bwd_plain(q, k, v, do, L, D, lens_t)
    for got, want in zip((dq, dk, dv), ref):
        mx, mean = _rel(got, want)
        assert mx < 2e-2 and mean < 4e-3, (mx, mean)
    assert (FA.KERNEL_STATS.launches - c0, FA.KERNEL_DQ.launches - d0,
            FA.KERNEL_DKV.launches - e0) == (1, 1, 1)
    for i, ln in enumerate(lens):
        if ln == 0:
            assert torch.all(o[i] == 0) and torch.all(L[i] == FA.NO_KEY_LSE)
            assert torch.all(dq[i] == 0)
        # keys past lens get exactly zero gradient (whole tiles and the ragged one)
        assert torch.all(dk[i, :, ln:] == 0) and torch.all(dv[i, :, ln:] == 0)


def test_flash_trainable_grads_match_fp32_autograd(gen):
    """The autograd Function (kernels C, D, E) against fp32 autograd through
    the plain attention, padded query rows masked out of the loss."""
    n, lens = 300, [300, 211]
    q, k, v, do, lens_t = _train_inputs(gen, n, lens)
    mask = torch.arange(n, device="cuda")[None, :] < lens_t[:, None]
    mq = mask[:, None, :, None].float()
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention_trainable(*xs, mask)
    got = torch.autograd.grad((out.float() * do.float() * mq).sum(), xs)
    xf = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad((FA.flash_attention_plain(*xf, lens_t) * do.float() * mq).sum(), xf)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.bfloat16
        mx, mean = _rel(g_, w_)
        assert mx < 2e-2 and mean < 4e-3, (mx, mean)


@pytest.mark.parametrize("seg", [None, 256])
def test_backward_kernels_are_deterministic(gen, seg):
    """One owner per output tile and no atomics: two launches of D and E on
    the same inputs give bitwise-equal gradients, in every configuration."""
    n = 389
    q, k, v, do, _ = _train_inputs(gen, n, [0, 0])
    if seg is None:
        lens = torch.tensor([n, 301], dtype=torch.int32, device="cuda")
    else:
        lens = torch.tensor([[256, 133], [200, 17]], dtype=torch.int32, device="cuda")
    o, L = FA.flash_attention_fwd_stats(q, k, v, lens, seg=seg)
    D = (do.float() * o.float()).sum(-1).contiguous()
    for cfg in FA.BWD_CONFIGS:
        runs = [(FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens, seg, config=cfg),
                 *FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens, seg, config=cfg))
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b), cfg
        ref = FA.flash_attention_bwd_plain(q, k, v, do, L, D, lens, seg)
        for got, want in zip(runs[0], ref):
            mx, mean = _rel(got, want)
            assert mx < 2e-2 and mean < 4e-3, (cfg, mx, mean)


def test_flash_bwd_kernels_take_fp32(gen):
    q, k, v, do, lens_t = _train_inputs(gen, 130, [130, 64], dtype=torch.float32)
    o, L = FA.flash_attention_fwd_stats(q, k, v, lens_t)
    D = (do * o).sum(-1).contiguous()
    for got, want in zip(FA.flash_attention_bwd(q, k, v, do, L, D, lens_t),
                         FA.flash_attention_bwd_plain(q, k, v, do, L, D, lens_t)):
        assert got.dtype == torch.float32
        mx, mean = _rel(got, want)
        assert mx < 2e-2 and mean < 4e-3, (mx, mean)


SEG_CASES = [  # (n, seg, lens_a, lens_t)
    (256, 200, [200, 131], [56, 9]),      # boundary inside a key tile
    (1077, 1000, [1000, 790], [77, 0]),   # odd length; row 1 without text
    (300, 256, [0, 256], [0, 44]),        # row 0: both segments empty
    (512, 256, [256, 128], [256, 64]),    # seg and both segments' ends on tile edges
    (700, 600, [600, 333], [100, 77]),    # seg inside a tile, ends inside tiles
]


@pytest.mark.parametrize("n,seg,la,lt", SEG_CASES, ids=["tile", "odd", "empty", "edge", "inside"])
def test_two_segment_kernels_match_plain(gen, n, seg, la, lt):
    """Kernel F and kernels C, D, E in the two-segment mode against their
    plain versions; keys outside both segments get exactly zero dk, dv."""
    q, k, v, do, _ = _train_inputs(gen, n, la)
    lens2 = torch.tensor([la, lt], dtype=torch.int32, device="cuda").T.contiguous()
    counts = [kern.launches for kern in (FA.KERNEL_SEG, FA.KERNEL_STATS_SEG, FA.KERNEL_DQ_SEG,
                                         FA.KERNEL_DKV_SEG, FA.KERNEL, FA.KERNEL_STATS)]
    o_f = FA.flash_attention_two_segment(q, k, v, lens2[:, 0], lens2[:, 1], seg)
    o, L = FA.flash_attention_fwd_stats(q, k, v, lens2, seg=seg)
    o_ref, L_ref = FA.flash_attention_fwd_stats_plain(q, k, v, lens2, seg=seg)
    for got in (o_f, o):
        err = (got.float() - o_ref.float()).abs()
        assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    assert (L - L_ref).abs().max().item() < 1e-2
    D = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, do, L, D, lens2, seg=seg)
    ref = FA.flash_attention_bwd_plain(q, k, v, do, L, D, lens2, seg=seg)
    for got, want in zip((dq, dk, dv), ref):
        mx, mean = _rel(got, want)
        assert mx < 2e-2 and mean < 4e-3, (mx, mean)
    after = [kern.launches for kern in (FA.KERNEL_SEG, FA.KERNEL_STATS_SEG, FA.KERNEL_DQ_SEG,
                                        FA.KERNEL_DKV_SEG, FA.KERNEL, FA.KERNEL_STATS)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1, 1, 0, 0]
    valid = FA.key_valid(lens2, n, seg)
    for i in range(2):
        assert torch.all(dk[i][:, ~valid[i]] == 0) and torch.all(dv[i][:, ~valid[i]] == 0)
        if la[i] + lt[i] == 0:
            assert torch.all(o_f[i] == 0) and torch.all(o[i] == 0)
            assert torch.all(L[i] == FA.NO_KEY_LSE) and torch.all(dq[i] == 0)


def test_two_segment_trainable_grads_match_fp32_autograd(gen):
    """The autograd Function in the two-segment mode (kernels C, D, E)
    against fp32 autograd through the plain attention; padded query rows of
    both segments masked out of the loss, as MMDiT's re-mask does."""
    n, seg = 333, 260
    q, k, v, do, _ = _train_inputs(gen, n, [0, 0])
    la = torch.tensor([260, 201], dtype=torch.int32, device="cuda")
    lt = torch.tensor([73, 12], dtype=torch.int32, device="cuda")
    lens2 = torch.stack([la, lt], 1).contiguous()
    mq = FA.key_valid(lens2, n, seg)[:, None, :, None].float()
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention_two_segment_trainable(*xs, la, lt, seg)
    got = torch.autograd.grad((out.float() * do.float() * mq).sum(), xs)
    xf = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = FA.flash_attention_two_segment_plain(*xf, lens2, seg)
    want = torch.autograd.grad((ref * do.float() * mq).sum(), xf)
    for g_, w_ in zip(got, want):
        mx, mean = _rel(g_, w_)
        assert mx < 2e-2 and mean < 4e-3, (mx, mean)


# kernel G at the F5TTS_v1_Base serving shapes (m = 1024: qkv, out, ff in,
# ff out), m = 1 and 4096, and ragged shapes (k % 16 != 0 in the last two)
G_SHAPES = [(1024, 1024, 3072), (1024, 1024, 1024), (1024, 1024, 4096), (1024, 4096, 1024),
            (1, 4096, 1024), (1, 1024, 3072), (4096, 1024, 3072), (96, 192, 80),
            (37, 1000, 200), (5, 40, 24)]


@pytest.mark.parametrize("m,k,n", G_SHAPES)
def test_int8_kernel_matches_plain(gen, m, k, n):
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    x_q, xs = Q.quantize_rows(x)
    w_q, ws = Q.quantize_weight(w)
    before = Q.KERNEL.launches
    got = Q.int8_matmul(x_q, xs, w_q, ws)
    assert Q.KERNEL.launches == before + 1
    want = Q.int8_matmul_plain(x_q, xs, w_q, ws)
    assert ((got - want).abs() / want.abs().clamp(min=1e-30)).max().item() <= 1e-6
    assert torch.equal(got, want)  # the int32 sum is exact, the epilogue rounds as the plain one


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", G_SHAPES)
def test_int8_linear_kernel_matches_plain_composition(gen, m, k, n, dtype):
    """The serving instance (one launch: row quantization, product, cast,
    bias) is bitwise the plain composition on the card, with and without a
    bias, and so is its two-launch form."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    x[0] = 0  # an all-zero row: scale 1e-8 / 127
    w_q, ws = Q.quantize_weight(torch.randn((n, k), generator=gen, device="cuda") * 0.02)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    for b in (bias, None):
        before, before_tpu = Q.KERNEL_LINEAR.launches, Q.KERNEL.launches
        got = Q.linear_w8a8(x, w_q, ws, b)
        assert Q.KERNEL_LINEAR.launches == before + 1 and Q.KERNEL.launches == before_tpu
        assert got.dtype == dtype and got.shape == (m, n)
        want = Q.linear_w8a8_plain(x, w_q, ws, b)
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
        assert torch.equal(Q.linear_w8a8_cuda(x, w_q, ws, b, launches=2), want)


@pytest.mark.parametrize("m,k,n", [(1024, 4096, 1024), (1, 4096, 1024), (130, 2008, 300),
                                   (64, 1152, 512)])
def test_int8_kernels_every_split_of_k(gen, m, k, n):
    """Both instances bitwise their plain versions at every split of k
    (partial tiles through the TMA path and, at k % 16 != 0, the cp.async
    one; a split count that would leave a split empty, 4 of 9 k steps, is
    lowered), launched twice: the int32 sums are order-free."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, ws = Q.quantize_weight(torch.randn((n, k), generator=gen, device="cuda") * 0.02)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    x_q, xs = Q.quantize_rows(x)
    want, want_lin = Q.int8_matmul_plain(x_q, xs, w_q, ws), Q.linear_w8a8_plain(x, w_q, ws, bias)
    for splits in (1, 2, 3, 4, 8):
        for _ in range(2):
            assert torch.equal(Q.int8_matmul_cuda(x_q, xs, w_q, ws, splits=splits), want), splits
            assert torch.equal(Q.linear_w8a8_cuda(x, w_q, ws, bias, splits=splits), want_lin), \
                splits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_divides_truly_on_the_card(gen, dtype):
    """quantize_rows gives the CPU's int8 values and scales on the card: its
    two divisions are true divisions on both devices; and kernel G's row
    phase (its division by a reciprocal and two corrections) gives them too,
    over 8M values whose rows span e^(+-9) in scale, with zero rows."""
    x = torch.randn((512, 1024), generator=gen, device="cuda") * torch.rand(
        (512, 1), generator=gen, device="cuda") * 10
    x = x.to(dtype)
    q, s = Q.quantize_rows(x)
    q_cpu, s_cpu = Q.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
    for k in (4096, 4224, 5000):  # the row held in registers, two passes, k % 16 != 0
        x = (torch.randn((2048, k), generator=gen, device="cuda") * torch.exp(
            torch.randn((2048, 1), generator=gen, device="cuda") * 3)).to(dtype)
        x[::97] = 0
        before = Q.KERNEL_LINEAR.launches
        q_k, s_k = Q.quantize_rows_cuda(x)
        assert Q.KERNEL_LINEAR.launches == before + 1
        q, s = Q.quantize_rows(x)
        assert torch.equal(q_k, q) and torch.equal(s_k, s), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1024, 4224, 1000])  # the row in registers, two passes, gathers
def test_int8_linear_kernel_nan_row(gen, dtype, k):
    """A row holding a NaN gets a NaN scale and a NaN output row from the
    serving instance and its row phase, as from the plain composition (the
    row max propagates NaN as torch.amax does); the other rows stay
    bitwise."""
    m, n = 40, 256
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    x[7, k // 3] = float("nan")
    w_q, ws = Q.quantize_weight(torch.randn((n, k), generator=gen, device="cuda") * 0.02)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    want = Q.linear_w8a8_plain(x, w_q, ws, bias)
    q, s = Q.quantize_rows(x)
    rest = torch.arange(m, device="cuda") != 7
    for launches in (1, 2):
        got = Q.linear_w8a8_cuda(x, w_q, ws, bias, launches=launches)
        assert torch.equal(got.isnan(), want.isnan()) and got[7].isnan().all()
        assert torch.equal(got[rest], want[rest])
    q_k, s_k = Q.quantize_rows_cuda(x)
    assert torch.equal(s_k.isnan(), s.isnan()) and s_k[7].isnan().all()
    assert torch.equal(s_k[rest], s[rest]) and torch.equal(q_k[rest], q[rest])


def _g_case(gen, m, k=4096, n=1024):
    """Inputs of the serving instance at a shape that splits k (partials
    and arrival counters in the workspaces), and its plain output."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, ws = Q.quantize_weight(torch.randn((n, k), generator=gen, device="cuda") * 0.02)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return (x, w_q, ws, bias), Q.linear_w8a8_plain(x, w_q, ws, bias)


def test_int8_kernel_workspaces_are_per_stream(gen):
    """Kernel G launched on two streams at once, at a split of k, many
    times over: each stream has its own scratch and arrival counters, so
    every output stays bitwise its plain version."""
    from f5_tts_tpu_torch.ops import workspace as W

    cases = [_g_case(gen, m) for m in (1024, 512)]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (s, (args, _)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(Q.linear_w8a8_cuda(*args, splits=4))
    torch.cuda.synchronize()
    for got, (_, want) in zip(outs, cases):
        assert all(torch.equal(o, want) for o in got)
    ptrs = set()
    for s in streams:
        with torch.cuda.stream(s):
            ptrs.add(W.workspace(torch.device("cuda", torch.cuda.current_device()),
                                 "G scratch", 1).data_ptr())
    assert len(ptrs) == 2
    for s in streams:
        W.release(s)


def test_int8_kernel_workspace_held_by_a_graph(gen):
    """A CUDA graph replays into the workspaces it captured: a larger call
    on the capture stream raises instead of freeing them under the graph,
    the same call on another stream runs, the graph still replays bitwise,
    and once the stream is released the larger call runs there too.  A
    capture on a stream with no workspace yet raises (nothing is allocated
    inside a capture)."""
    from f5_tts_tpu_torch.ops import workspace as W

    (args, want), (big, want_big) = _g_case(gen, 256), _g_case(gen, 2048)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q.linear_w8a8_cuda(*args, splits=4)  # the workspaces of the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = Q.linear_w8a8_cuda(*args, splits=4)
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="held by a CUDA graph"):
            Q.linear_w8a8_cuda(*big, splits=4)
    assert torch.equal(Q.linear_w8a8_cuda(*big, splits=4), want_big)  # another stream
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    del graph
    W.release(side)
    with torch.cuda.stream(side):
        got = Q.linear_w8a8_cuda(*big, splits=4)
    torch.cuda.synchronize()
    assert torch.equal(got, want_big)
    W.release(side)
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            Q.linear_w8a8_cuda(*args, splits=4)


def test_w8a8_linear_launches_the_int8_kernel(gen):
    lin = torch.nn.Linear(256, 384).cuda().to(torch.bfloat16)
    Q.quantize_linear_params(lin)
    from f5_tts_tpu_torch.models.layers import linear

    x = torch.randn((3, 50, 256), generator=gen, device="cuda").to(torch.bfloat16)
    before = Q.KERNEL_LINEAR.launches
    y = linear(lin, x)
    assert Q.KERNEL_LINEAR.launches == before + 1 and y.dtype == torch.bfloat16 and \
        y.shape == (3, 50, 384)
    want = Q.linear_w8a8(x.cpu(), lin.weight_q.cpu(), lin.w_scale.cpu(), lin.bias.cpu())
    assert (y.cpu().float() - want.float()).abs().max().item() <= 1e-2


PIPE_CASES = [  # (b, h, n, lens): ragged n, lens 0, a straddling length, b*h = 128
    (2, 4, 1024, [1024, 824]), (2, 4, 1000, [0, 963]), (2, 4, 65, [65, 1]),
    (2, 4, 1025, [1025, 127]), (2, 16, 4096, [4096, 4059]), (1, 1, 1, [1]),
    (8, 16, 1024, [1024, 1000, 1, 64, 129, 512, 1023, 0]),
]


@pytest.mark.parametrize("b,h,n,lens", PIPE_CASES)
def test_pipelined_flash_kernel_matches_plain(gen, b, h, n, lens):
    q, k, v = (torch.randn((b, h, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens_t)
    for cfg in XH.CONFIGS:
        before = XH.KERNEL.launches
        got = XH.flash_pipe(q, k, v, lens_t, *cfg)
        assert XH.KERNEL.launches == before + 1
        err = (got.float() - want).abs()
        assert err.max().item() < 2e-2 and err.mean().item() < 2e-3, cfg
        for i, kv in enumerate(lens):
            if kv == 0:
                assert torch.all(got[i] == 0), cfg
        assert torch.equal(got, XH.flash_pipe(q, k, v, lens_t, *cfg)), cfg  # no atomics


def test_pipelined_flash_kernel_graph_replay_is_bitwise(gen):
    """The tensor maps are kernel parameters: a captured launch replays on
    the buffers it was captured with and matches the eager call bitwise."""
    q, k, v = (torch.randn((2, 16, 1025, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([1025, 127], dtype=torch.int32, device="cuda")
    for cfg in XH.CONFIGS:
        eager = XH.flash_pipe(q, k, v, lens, *cfg)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            XH.flash_pipe(q, k, v, lens, *cfg)  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = XH.flash_pipe(q, k, v, lens, *cfg)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), cfg
        q.mul_(-1)  # new inputs in the captured buffers: the replay reads them
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, XH.flash_pipe(q, k, v, lens, *cfg)), cfg
        q.mul_(-1)


def test_pipelined_flash_kernel_on_two_streams_at_once(gen):
    shapes = ((2, 16, 1024, [1024, 824]), (4, 8, 777, [777, 1, 0, 500]))
    ins = []
    for b, h, n, lens in shapes:
        qkv = [torch.randn((b, h, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
        ins.append((*qkv, torch.tensor(lens, dtype=torch.int32, device="cuda")))
    want = [XH.flash_pipe(*a) for a in ins]
    streams = [torch.cuda.Stream() for _ in ins]
    got = [None] * len(ins)
    torch.cuda.synchronize()
    for _ in range(5):
        for i, (st, a) in enumerate(zip(streams, ins)):
            with torch.cuda.stream(st):
                got[i] = XH.flash_pipe(*a)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_bounded_mbar_wait_traps_instead_of_hanging(gen):
    """A block waiting on an mbarrier that never completes traps after ~2 s
    (common.cuh mbar_wait), run in a process of its own since the trap
    ends the CUDA context."""
    import os
    import subprocess
    import sys

    from f5_tts_tpu_torch.ops.cuda_build import LIBRARY

    LIBRARY.build()  # the child reuses the libraries built here
    code = ("import sys, time, torch\n"
            "from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH\n"
            "torch.zeros(1, device='cuda')\n"
            "t = time.time()\n"
            "XH.probe_bounded_wait()\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    print(f'trapped {time.time() - t:.2f}')\n"
            "    sys.exit(0)\n"
            "sys.exit(1)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=root)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    seconds = float(r.stdout.split("trapped ")[1].split()[0])
    assert 1.0 <= seconds <= 10.0, seconds


@pytest.mark.parametrize("m,k,n", [(2048, 1024, 3072), (37, 1000, 1001), (100, 1024, 200),
                                   (8, 2048, 64), (256, 2048, 512), (130, 4096, 300),
                                   (64, 20, 36), (96, 1000, 256)])
def test_fused_ln_matmul_kernel_matches_plain(gen, m, k, n):
    args = XI.inputs(m, k, n, "cuda", seed=7)
    before = XI.KERNEL.launches
    got = XI.fused_ln_matmul(*args).float()
    assert XI.KERNEL.launches == before + 1
    want = XI.fused_ln_matmul_plain(*args).float()
    err = (got - want).abs() / want.abs().max()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


def test_fused_ln_matmul_kernel_refuses_fp32_x(gen):
    x, w, bias, sc, sh = XI.inputs(8, 2048, 64, "cuda")
    with pytest.raises(TypeError, match="bf16"):
        XI.fused_ln_matmul(x.float(), w, bias, sc, sh)


# The engine's CUDA graphs: a narrow DiT (dim 1024 for kernel B's 16 groups
# of 64 channels, depth 2, 16 heads of 64) and the full Vocos, bf16, NFE 4.

def _card_engine(quantize: bool):
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig
    from f5_tts_tpu_torch.models.vocos import Vocos

    torch.manual_seed(0)
    cfg = ModelConfig(name="narrow", arch=DiTConfig(depth=2, text_dim=64, conv_layers=1),
                      tokenizer="char")
    cfm = CFM(cfg.arch)
    randomize_zero_init(cfm.transformer, torch.Generator().manual_seed(1))
    return InferenceEngine(cfm.cuda(), cfg, vocoder=Vocos().cuda(), dtype=torch.bfloat16,
                           options=EngineOptions(nfe_step=4, quantize=quantize))


def _request(b, seed=0):
    rng = np.random.default_rng(seed)
    refs = [(0.2 * rng.standard_normal(int(24000 * (0.8 + 0.3 * i)))).astype(np.float32)
            for i in range(b)]
    ids = [rng.integers(0, 200, size=30 + 5 * i).astype(np.int32) for i in range(b)]
    return refs, ids, [300 + 20 * i for i in range(b)], [seed + i for i in range(b)]


def _recorded_run(eng):
    """Wrap ``eng._run`` to keep each call's (entry, args, decode, out)."""
    calls = []
    inner = eng._run

    def run(entry, args, decode):
        out = inner(entry, args, decode)
        calls.append((entry, args, decode, out))
        return out

    eng._run = run
    return calls


@pytest.mark.parametrize("quantize", [False, True], ids=["dense", "w8a8"])
def test_engine_graph_replay_is_bitwise_eager(gen, quantize):
    """Every engine call replays its graph; with the same inputs and noise
    the replay equals the module-level eager function bitwise, in mel and
    int16 wav, at batch 1 and 2, both entries."""
    from f5_tts_tpu_torch.infer import engine as TE

    eng = _card_engine(quantize)
    calls = _recorded_run(eng)
    for b in (1, 2):
        refs, ids, durs, seeds = _request(b, seed=b)
        eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)
        eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)  # a replay of a known key
        mels = [np.zeros((len(r) // 256, 100), np.float32) for r in refs]
        eng.generate_batch(mels, ids, durs, seeds=seeds)
    assert len(eng.graphs) == 4 and len(calls) == 6
    for entry, args, decode, (mel, wav) in calls:
        if entry == "wav":
            want = TE.sample_and_decode_from_wav(eng.model.transformer, eng.vocoder,
                                                 eng.model_cfg, eng.options, *args,
                                                 args[-1].shape[1], decode=decode)
        else:
            want = TE.sample_and_decode(eng.model.transformer, eng.vocoder, eng.model_cfg,
                                        eng.options, *args, decode=decode)
        assert torch.equal(mel, want[0]) and torch.equal(wav, want[1]), entry
        assert wav.dtype == torch.int16 and torch.isfinite(mel.float()).all()


@pytest.mark.parametrize("quantize", [False, True], ids=["dense", "w8a8"])
def test_engine_replays_add_their_launches(gen, quantize):
    """A's, B's and G's counts after N replays are N times one eager call's
    (the capture itself counts nothing); G launches only when W8A8."""
    from f5_tts_tpu_torch.infer import engine as TE

    eng = _card_engine(quantize)
    refs, ids, durs, seeds = _request(1)
    calls = _recorded_run(eng)
    eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)  # captures the key
    kernels = (FA.KERNEL, FC.KERNEL, Q.KERNEL_LINEAR)
    for k in kernels:
        k.launches = 0
    _, args, decode, _ = calls[0]
    TE.sample_and_decode_from_wav(eng.model.transformer, eng.vocoder, eng.model_cfg,
                                  eng.options, *args, args[-1].shape[1], decode=decode)
    eager = [k.launches for k in kernels]
    assert eager[0] == 2 * 4 and eager[1] == 4 and eager[2] == (4 * 2 * 4 if quantize else 0)
    for k in kernels:
        k.launches = 0
    for _ in range(3):
        eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)
    assert [k.launches for k in kernels] == [3 * c for c in eager]


def test_engine_two_threads_replay_one_engine(gen):
    """Two threads serve different requests through one engine at once
    (the graphs share one pool and one lock); each row equals the same
    request served alone."""
    import threading

    eng = _card_engine(False)
    reqs = [_request(1, seed=s) for s in (1, 2, 3, 4)] + [_request(2, seed=5)]
    want = [eng.generate_batch_from_wavs(*r[:3], seeds=r[3])[1] for r in reqs]
    got, errors = {}, []

    def worker(t):
        try:
            for rep in range(3):
                for i in range(t, len(reqs), 2):
                    got[(i, rep)] = eng.generate_batch_from_wavs(*reqs[i][:3],
                                                                 seeds=reqs[i][3])[1]
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(got) == 3 * len(reqs)
    for (i, _), wavs in got.items():
        for a, b in zip(wavs, want[i]):
            np.testing.assert_array_equal(a, b)


def _narrow_bigvgan(seed: int = 0):
    """BigVGAN v2's structure (six upsample stages, three AMP blocks each) at
    128 initial channels (2 at the end), seeded torch-default weights."""
    from f5_tts_tpu_torch.models import bigvgan as BV

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return BV.BigVGAN(BV.BigVGANConfig(upsample_initial_channel=128)).eval()


def test_bigvgan_decode_on_card_matches_cpu(gen):
    """fp32 with TF32 off: cuDNN's convs against the CPU's, 1e-4 abs on a
    waveform in [-1, 1]; with cuDNN's TF32 default (the engine's) within
    1e-2.  The activations' filters are buffers: the decode copies nothing
    from the host."""
    import copy

    from f5_tts_tpu_torch.models import bigvgan as BV

    voc = _narrow_bigvgan()
    mel = torch.randn((2, 37, 100), generator=torch.Generator().manual_seed(1)) - 5.0
    want = BV.decode(voc, mel)
    card = copy.deepcopy(voc).cuda()
    assert all(b.is_cuda for b in card.buffers())
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = BV.decode(card, mel.cuda()).cpu()
    assert got.shape == (2, 37 * 256) and 0.01 < want.abs().max() < 1.0
    assert (got - want).abs().max() < 1e-4
    assert (BV.decode(card, mel.cuda()).cpu() - want).abs().max() < 1e-2


def test_bigvgan_mel_on_card_matches_cpu(gen):
    """The bigvgan log-mel on the card against ``log_mel_np`` on the CPU:
    1e-3 max abs in log units (chip_smoke's ``BIGVGAN_MEL_TOL``)."""
    from f5_tts_tpu_torch.ops import mel as M

    cfg = M.MelConfig(mel_spec_type="bigvgan")
    wav = (0.3 * np.random.default_rng(2).standard_normal(31_000)).astype(np.float32)
    pad = M.stft_pad_amount(cfg)
    padded = np.pad(np.pad(wav, pad, mode="reflect"), (0, 2048))[None]
    got = M.log_mel_prepadded(torch.from_numpy(padded).cuda(), cfg).cpu().numpy()
    k = M.num_frames(len(wav), cfg)
    np.testing.assert_allclose(got[:, :k], M.log_mel_np(wav, cfg), atol=1e-3)


def _card_bigvgan_engine(window: int = 0):
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.bigvgan import BigVGAN
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig
    from f5_tts_tpu_torch.ops.mel import MelConfig

    torch.manual_seed(0)
    cfg = ModelConfig(name="narrow", arch=DiTConfig(depth=2, text_dim=64, conv_layers=1),
                      tokenizer="char", mel=MelConfig(mel_spec_type="bigvgan"))
    cfm = CFM(cfg.arch)
    randomize_zero_init(cfm.transformer, torch.Generator().manual_seed(1))
    with torch.random.fork_rng(devices=[]):  # BigVGAN v2 at its published widths
        torch.manual_seed(2)
        voc = BigVGAN()
    return InferenceEngine(cfm.cuda(), cfg, vocoder=voc.cuda(), dtype=torch.bfloat16,
                           options=EngineOptions(nfe_step=4, time_parallel_window=window,
                                                 picard_tol=0.0))


@pytest.mark.parametrize("window", [0, 2], ids=["sequential", "picard"])
def test_engine_bigvgan_and_picard_replays_are_bitwise_eager(gen, window):
    """A BigVGAN engine's replays (a narrow DiT and BigVGAN v2 at full
    width; one graph, under Picard the prelude, the sweeps and the epilogue)
    equal the module-level eager function bitwise, wavs of n * 256 samples; under Picard at tol 0 every call sweeps once
    per step, and a call counts depth A and one B launch per sweep."""
    from f5_tts_tpu_torch.infer import engine as TE

    eng = _card_bigvgan_engine(window)
    assert eng.vocoder_type == "bigvgan"
    calls = _recorded_run(eng)
    for b in (1, 2):
        refs, ids, durs, seeds = _request(b, seed=b)
        eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)
        eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)
    assert len(eng.graphs) == 2 and len(calls) == 4
    if window:
        assert all(isinstance(g, TE.CapturedPicard) for g in eng.graphs.values())
        assert eng.last_sweeps == 4
    for entry, args, decode, (mel, wav) in calls:
        want = TE.sample_and_decode_from_wav(eng.model.transformer, eng.vocoder, eng.model_cfg,
                                             eng.options, *args, args[-1].shape[1],
                                             decode=decode, vocoder_type="bigvgan")
        assert torch.equal(mel, want[0]) and torch.equal(wav, want[1])
        assert wav.shape[1] == args[-1].shape[1] * 256
    FA.KERNEL.launches = FC.KERNEL.launches = 0
    eng.generate_batch_from_wavs(refs, ids, durs, seeds=seeds)
    forwards = eng.last_sweeps if window else 4
    assert (FA.KERNEL.launches, FC.KERNEL.launches) == (2 * forwards, forwards)
