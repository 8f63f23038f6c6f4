"""The port's training attention (ops/flash_attention.py: kernel C's forward
with logsumexp, kernels D and E's backward, the autograd Function around
them) against the JAX package.

The JAX functions run their Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU.  The port's CPU tensors go through
the plain versions under the same autograd Function that launches the
kernels on the card (tests/test_torch_cuda.py holds the kernels against the
plain versions there).

Tolerances: the Pallas kernels round q (prescaled by scale * log2 e), k, v,
do, p and ds to bf16, the port's plain versions compute in fp32 on the same
values.  Outputs: atol 2e-2 and mean < 2e-3, as tests/test_flash_attention.py;
logsumexp: atol 2e-2; gradients, relative to the largest reference value:
max 2e-2, mean 4e-3.  The plain backward against fp32 autograd: atol 1e-5.
Inputs keep every ``lens >= 1`` where JAX is the reference: a row with no
valid key is where the TPU kernels depart from the documented zero rule.

The card's kernels (the forward A, C, F and the backward D, E) compute the
scores from the raw bf16 q and k and apply scale * log2 e in fp32 inside the
exponent, where the Pallas kernels round q * scale * log2 e to bf16 first.
Torch emulations of the card's arithmetic are held against the Pallas
forward (outputs within OUT_TOL, logsumexp within LSE_TOL) and backward
(within the card checks' gradient tolerance, chip_smoke.py GRAD_TOL, the
same 2e-2 max and 4e-3 mean relative error as below).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.ops import flash_attention as JFA
from f5_tts_tpu_torch.ops import attention as TA
from f5_tts_tpu_torch.ops import flash_attention as TFA

OUT_TOL = (2e-2, 2e-3)
LSE_TOL = 2e-2
GRAD_TOL = (2e-2, 4e-3)


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n, lens, b=2, h=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4))
    return q, k, v, do, np.asarray(lens, np.int32)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _assert_rel(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / max(np.abs(want).max(), 1e-12)
    assert err.max() < tol[0] and err.mean() < tol[1], (err.max(), err.mean())


@pytest.mark.parametrize("n,lens", [(256, [256, 200]), (384, [131, 384])])
def test_fwd_stats_matches_jax_kernel(interpret, n, lens):
    q, k, v, _, lens_np = _inputs(n, lens)
    blk = JFA._pick_block(n, 256)
    o_j, L_j = JFA._flash_fwd_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens_np), blk, blk)
    o_t, L_t = TFA.flash_attention_fwd_stats(_t(q), _t(k), _t(v), _t(lens_np))
    err = np.abs(o_t.numpy() - np.asarray(o_j))
    assert err.max() < OUT_TOL[0] and err.mean() < OUT_TOL[1]
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j).reshape(L_t.shape), atol=LSE_TOL)


@pytest.mark.parametrize("n,lens", [(256, [256, 170]), (384, [384, 301])])
def test_trainable_grads_match_jax_kernels(interpret, n, lens):
    """Gradients through flash_attention_trainable; padded query rows are
    masked out of the loss, as the model's re-mask does."""
    q, k, v, do, lens_np = _inputs(n, lens, seed=1)
    mask = np.arange(n)[None, :] < lens_np[:, None]
    mq = mask[:, None, :, None].astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(JFA.flash_attention_trainable(q_, k_, v_, jnp.asarray(mask)) * do * mq)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [_t(a, grad=True) for a in (q, k, v)]
    out = TFA.flash_attention_trainable(*xs, _t(mask))
    got = torch.autograd.grad((out * _t(do) * _t(mq)).sum(), xs)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w)


def test_with_stats_logsumexp_cotangent_matches_jax(interpret):
    n = 256
    q, k, v, do, lens_np = _inputs(n, [256, 97], seed=2)
    dl = np.random.default_rng(3).standard_normal((2, 2, n)).astype(np.float32)

    def jloss(q_, k_, v_):
        o, L = JFA.flash_attention_with_stats(q_, k_, v_, jnp.asarray(lens_np))
        return jnp.sum(o * do) + jnp.sum(L.reshape(dl.shape) * dl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [_t(a, grad=True) for a in (q, k, v)]
    o, L = TFA.flash_attention_with_stats(*xs, _t(lens_np))
    got = torch.autograd.grad((o * _t(do)).sum() + (L * _t(dl)).sum(), xs)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w)


@pytest.mark.parametrize("with_dl", [False, True])
def test_plain_backward_matches_fp32_autograd(with_dl):
    """flash_attention_bwd_plain (the kernels' formulas, not autograd) against
    autograd through the plain attention, with and without a logsumexp
    cotangent."""
    q, k, v, do, lens_np = _inputs(96, [96, 41], h=3, dh=16, seed=4)
    dl = np.random.default_rng(5).standard_normal((2, 3, 96)).astype(np.float32)
    lens = _t(lens_np)
    xs = [_t(a, grad=True) for a in (q, k, v)]
    s = TFA._masked_scores(xs[0], xs[1], lens)
    L = torch.logsumexp(s, dim=-1)
    o = torch.softmax(s, dim=-1) @ xs[2]
    loss = (o * _t(do)).sum() + ((L * _t(dl)).sum() if with_dl else 0.0)
    want = torch.autograd.grad(loss, xs)
    D = (_t(do) * o.detach()).sum(-1) - (_t(dl) if with_dl else 0.0)
    got = TFA.flash_attention_bwd_plain(*(x.detach() for x in xs), _t(do), L.detach(), D, lens)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_zero_length_row_gives_zero_output_and_gradients():
    q, k, v, do, lens_np = _inputs(80, [0, 80], seed=6)
    xs = [_t(a, grad=True) for a in (q, k, v)]
    o, L = TFA.flash_attention_with_stats(*xs, _t(lens_np))
    assert torch.all(o[0] == 0) and torch.all(L[0] == TFA.NO_KEY_LSE)
    grads = torch.autograd.grad((o * _t(do)).sum(), xs)
    for g in grads:
        assert torch.all(g[0] == 0) and torch.isfinite(g).all() and g[1].abs().max() > 0


def test_with_stats_rejects_unequal_lengths():
    q = torch.zeros((1, 1, 8, 64))
    k = torch.zeros((1, 1, 6, 64))
    with pytest.raises(ValueError, match="len\\(q\\)==len\\(k\\)"):
        TFA.flash_attention_with_stats(q, k, k, torch.tensor([6], dtype=torch.int32))


@pytest.mark.parametrize("backend", ["flash_train", "train_auto"])
def test_train_backends_run_the_trainable_attention(backend):
    q, k, v, do, lens_np = _inputs(40, [40, 23], dh=16, seed=7)
    mask = _t(np.arange(40)[None, :] < lens_np[:, None])
    xs = [_t(a, grad=True) for a in (q, k, v)]
    got = TA.attention(*xs, mask=mask, backend=backend)
    want = TA.sdpa(*(_t(a) for a in (q, k, v)), mask=mask)
    mq = mask[:, None, :, None]
    np.testing.assert_allclose((got * mq).detach().numpy(), (want * mq).numpy(), atol=1e-5)
    assert got.grad_fn is not None


def _emulated_card_bwd(q, k, v, do, L, D, lens, seg=None):
    """Kernels D and E's arithmetic on the card: q, k, v, do rounded to bf16;
    fp32 scores of the raw bf16 q.k^T, scaled by scale * log2 e in fp32
    inside exp2; p = 0 on masked keys; p and ds rounded to bf16 for the
    products, which accumulate in fp32."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    qb, kb, vb, dob = (bf(_t(a)) for a in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = qb @ kb.transpose(-1, -2)
    p = torch.exp2(s * (scale * TFA.LOG2E) - _t(L)[..., None] * TFA.LOG2E)
    valid = TFA.key_valid(_t(lens), q.shape[2], seg)[:, None, None, :]
    p = torch.where(valid, p, torch.zeros_like(p))
    ds = p * (dob @ vb.transpose(-1, -2) - _t(D)[..., None])
    dq = (bf(ds) @ kb) * scale
    dk = (bf(ds).transpose(-1, -2) @ qb) * scale
    dv = bf(p).transpose(-1, -2) @ dob
    return dq, dk, dv


@pytest.mark.parametrize("n,lens,seg", [
    (256, [256, 170], None),
    (384, [131, 384], None),
    (320, [[256, 40], [190, 17]], 256),
], ids=["prefix", "prefix-ragged", "two-segment"])
def test_card_rounding_point_matches_jax_backward(interpret, n, lens, seg):
    """The moved rounding point of q (raw bf16 q.k^T, scale * log2 e in fp32)
    stays within the card's gradient tolerance of the Pallas backward, on
    the Pallas forward's L and D."""
    q, k, v, do, lens_np = _inputs(n, lens, seed=8)
    b, h, _, dh = q.shape
    blk = JFA._pick_block(n, 256)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o_j, L_j = JFA._flash_fwd_stats(jq, jk, jv, jnp.asarray(lens_np), blk, blk, seg)
    D_j = jnp.sum(jdo * o_j.astype(jnp.float32), axis=-1).reshape(b * h, 1, n)
    want = JFA._flash_bwd(jq, jk, jv, jdo, L_j, D_j, jnp.asarray(lens_np), blk, blk, seg)
    L, D = (np.asarray(x).reshape(b, h, n) for x in (L_j, D_j))
    got = _emulated_card_bwd(q, k, v, do, L, D, lens_np, seg)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, GRAD_TOL)


def _emulated_card_fwd(q, k, v, lens, seg=None):
    """Kernels A, C and F's arithmetic on the card: q, k, v rounded to bf16;
    fp32 scores of the raw bf16 q.k^T; p = exp2((s - m) * scale * log2 e),
    m the row max of the raw scores; the row sum l of the fp32 p; p rounded
    to bf16 for P.V, accumulated in fp32; o = P.V / l and the natural-log
    L = (m * scale * log2 e + log2 l) / log2 e.  (o, L)."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    qb, kb, vb = (bf(_t(a)) for a in (q, k, v))
    qscale = q.shape[-1] ** -0.5 * TFA.LOG2E
    s = qb @ kb.transpose(-1, -2)
    valid = TFA.key_valid(_t(lens), q.shape[2], seg)[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * qscale)
    l = p.sum(dim=-1, keepdim=True)
    o = (bf(p) @ vb) / l
    L = (m * qscale + torch.log2(l))[..., 0] / TFA.LOG2E
    return o, L


@pytest.mark.parametrize("n,lens,seg", [
    (256, [256, 170], None),
    (384, [131, 384], None),
    (320, [[256, 40], [190, 17]], 256),
], ids=["prefix", "prefix-ragged", "two-segment"])
def test_card_rounding_point_matches_jax_forward(interpret, n, lens, seg):
    """The moved rounding point of q (raw bf16 q.k^T, scale * log2 e in fp32
    inside exp2) stays within the forward tolerances of the Pallas kernels:
    _flash (or _flash_seg with seg) for the output, _flash_fwd_stats for the
    output and the logsumexp."""
    q, k, v, _, lens_np = _inputs(n, lens, seed=9)
    b, h, _, dh = q.shape
    blk = JFA._pick_block(n, 256)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens_np))
    o_j, L_j = JFA._flash_fwd_stats(jq, jk, jv, jl, blk, blk, seg)
    if seg is None:
        o_serve = JFA._flash(jq, jk, jv, jl, blk, blk)
    else:
        o_serve = JFA._flash_seg(jq, jk, jv, jl, seg, blk, blk)
    o, L = _emulated_card_fwd(q, k, v, lens_np, seg)
    for want in (o_j, o_serve):
        err = np.abs(o.numpy() - np.asarray(want))
        assert err.max() < OUT_TOL[0] and err.mean() < OUT_TOL[1], (err.max(), err.mean())
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j).reshape(b, h, n), atol=LSE_TOL)
