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
Kernel G (the W8A8 int8 product) must equal its plain version to 1e-6
relative (the int32 sum is exact; the output is bitwise the plain one's),
at ragged m, k, n too, and a W8A8 linear on the card must launch it.
Kernels H (pipelined flash attention, every tile configuration) and I
(fused LayerNorm-modulate matmul) are held as kernel A: 2e-2 max, 2e-3
mean error, I's relative to the largest reference value.  The forward
kernels A, C, F and kernel B (ConvPositionEmbedding) are checked in every
configuration built (``FWD_CONFIGS``, ``fused_convpos.CONFIGS``) at
n = 1, 63, 65, 127, 129, lengths of 0 and lengths that end on a tile edge
beside ones that end inside a tile, with a two-launch bitwise determinism
check; B's fp32 instance (three bf16 products) against the fp32 plain
version, TF32 off, to 1e-4 relative to the largest reference value.
"""

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


@pytest.mark.parametrize("m,k,n", [(1024, 1024, 3072), (1, 4096, 1024), (96, 192, 80),
                                   (37, 1000, 200)])
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


def test_w8a8_linear_launches_the_int8_kernel(gen):
    lin = torch.nn.Linear(256, 384).cuda().to(torch.bfloat16)
    Q.quantize_linear_params(lin)
    from f5_tts_tpu_torch.models.layers import linear

    x = torch.randn((3, 50, 256), generator=gen, device="cuda").to(torch.bfloat16)
    before = Q.KERNEL.launches
    y = linear(lin, x)
    assert Q.KERNEL.launches == before + 1 and y.dtype == torch.bfloat16 and y.shape == (3, 50, 384)
    want = Q.linear_w8a8(x.cpu(), lin.weight_q.cpu(), lin.w_scale.cpu(), lin.bias.cpu())
    assert (y.cpu().float() - want.float()).abs().max().item() <= 1e-2


@pytest.mark.parametrize("n,lens", [(1024, [1024, 824]), (1000, [0, 963]), (65, [65, 1])])
def test_pipelined_flash_kernel_matches_plain(gen, n, lens):
    q, k, v = (torch.randn((2, 4, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens_t)
    for bq, bk in XH.CONFIGS:
        before = XH.KERNEL.launches
        got = XH.flash_pipe(q, k, v, lens_t, bq, bk).float()
        assert XH.KERNEL.launches == before + 1
        err = (got - want).abs()
        assert err.max().item() < 2e-2 and err.mean().item() < 2e-3, (bq, bk)
        if 0 in lens:
            assert torch.all(got[lens.index(0)] == 0)


@pytest.mark.parametrize("m,k,n", [(2048, 1024, 3072), (37, 1000, 1001), (100, 1024, 200)])
def test_fused_ln_matmul_kernel_matches_plain(gen, m, k, n):
    args = XI.inputs(m, k, n, "cuda", seed=7)
    before = XI.KERNEL.launches
    got = XI.fused_ln_matmul(*args).float()
    assert XI.KERNEL.launches == before + 1
    want = XI.fused_ln_matmul_plain(*args).float()
    err = (got - want).abs() / want.abs().max()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    with pytest.raises(ValueError, match="shared-memory"):
        XI.fused_ln_matmul(*XI.inputs(8, 2048, 64, "cuda"))

