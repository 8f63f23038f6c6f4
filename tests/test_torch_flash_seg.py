"""The port's two-segment attention (ops/flash_attention.py: kernel F's plain
version, and kernels C, D and E in the two-segment mode under the autograd
Function) against the JAX package and against fp32 SDPA.

Keys are valid in [0, len_a) U [seg, seg + len_t): MMDiT's joint [audio,
text] sequence.  The JAX functions run their Pallas kernels in interpret
mode, as the JAX package's own tests run them on the CPU; the port's CPU
tensors go through the plain versions (tests/test_torch_cuda.py holds the
kernels against them on the card).

Tolerances: against JAX, whose kernels round q (prescaled), k, v, do, p and
ds to bf16 where the plain versions compute in fp32: outputs and gradients
atol 2e-2 and mean < 2e-3, as tests/test_flash_attention.py.  Against fp32
SDPA with the concatenated key mask, and the plain backward against fp32
autograd: atol 1e-5.  ``seg`` = 200 puts the segment boundary inside a
64-key tile.  Rows where JAX is the reference keep a valid key: a row with
both segments empty is where the TPU kernel gives the mean of v, the port 0.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.ops import flash_attention as JFA
from f5_tts_tpu_torch.ops import flash_attention as TFA

TOL = (2e-2, 2e-3)
N, SEG = 256, 200


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n=N, b=2, h=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4)]


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _lens(la, lt):
    return np.asarray(la, np.int32), np.asarray(lt, np.int32)


def _assert_close(got, want, tol=TOL):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() < tol[0] and err.mean() < tol[1], (err.max(), err.mean())


def _sdpa(q, k, v, la, lt, seg):
    valid = TFA.key_valid(torch.from_numpy(np.stack([la, lt], 1)), q.shape[2], seg)
    mask = valid[:, None, None, :].expand(-1, 1, q.shape[2], -1)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def test_two_segment_forward_matches_jax_kernel(interpret):
    q, k, v, _ = _inputs()
    la, lt = _lens([180, 200], [40, 17])
    want = JFA.flash_attention_two_segment(*(jnp.asarray(a) for a in (q, k, v)),
                                           jnp.asarray(la), jnp.asarray(lt), seg=SEG)
    got = TFA.flash_attention_two_segment(_t(q), _t(k), _t(v), _t(la), _t(lt), SEG)
    _assert_close(got.numpy(), want)


def test_two_segment_trainable_grads_match_jax_kernels(interpret):
    """Output and gradients through the trainable function; padded query rows
    of both streams are masked out of the loss, as MMDiT's re-mask does."""
    q, k, v, do = _inputs(seed=1)
    la, lt = _lens([200, 151], [56, 9])
    rows = np.arange(N)[None, :]
    mq = (((rows < la[:, None]) | ((rows >= SEG) & (rows < SEG + lt[:, None])))
          [:, None, :, None].astype(np.float32))

    def jloss(q_, k_, v_):
        o = JFA.flash_attention_two_segment_trainable(q_, k_, v_, jnp.asarray(la),
                                                      jnp.asarray(lt), seg=SEG)
        return jnp.sum(o * do * mq), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [_t(a, grad=True) for a in (q, k, v)]
    o_t = TFA.flash_attention_two_segment_trainable(*xs, _t(la), _t(lt), SEG)
    assert o_t.grad_fn is not None
    _assert_close((o_t.detach() * _t(mq)).numpy(), np.asarray(o_j) * mq)
    g_t = torch.autograd.grad((o_t * _t(do) * _t(mq)).sum(), xs)
    for g, w in zip(g_t, g_j):
        _assert_close(g.numpy(), w)


@pytest.mark.parametrize("n,seg,la,lt", [(N, SEG, [180, 200], [40, 0]),
                                          (77, 70, [70, 3], [7, 5]),
                                          (96, 96, [96, 41], [0, 0])],
                         ids=["tile_boundary", "odd", "seg_at_end"])
def test_plain_forward_matches_fp32_sdpa(n, seg, la, lt):
    q, k, v, _ = _inputs(n=n, h=3, dh=16, seed=2)
    la, lt = _lens(la, lt)
    got = TFA.flash_attention_two_segment(_t(q), _t(k), _t(v), _t(la), _t(lt), seg)
    want = _sdpa(_t(q), _t(k), _t(v), la, lt, seg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    o, L = TFA.flash_attention_fwd_stats(_t(q), _t(k), _t(v), _t(np.stack([la, lt], 1)), seg=seg)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=1e-5)
    assert torch.isfinite(L).all()


@pytest.mark.parametrize("with_dl", [False, True])
def test_plain_backward_matches_fp32_autograd(with_dl):
    """flash_attention_bwd_plain in the two-segment mode (the kernels'
    formulas, not autograd) against autograd through the plain attention."""
    q, k, v, do = _inputs(n=90, h=3, dh=16, seed=4)
    lens2 = _t(np.array([[60, 17], [33, 30]], np.int32))
    seg = 60
    dl = np.random.default_rng(5).standard_normal((2, 3, 90)).astype(np.float32)
    xs = [_t(a, grad=True) for a in (q, k, v)]
    s = TFA._masked_scores(xs[0], xs[1], lens2, seg)
    L = torch.logsumexp(s, dim=-1)
    o = torch.softmax(s, dim=-1) @ xs[2]
    loss = (o * _t(do)).sum() + ((L * _t(dl)).sum() if with_dl else 0.0)
    want = torch.autograd.grad(loss, xs)
    D = (_t(do) * o.detach()).sum(-1) - (_t(dl) if with_dl else 0.0)
    got = TFA.flash_attention_bwd_plain(*(x.detach() for x in xs), _t(do), L.detach(), D, lens2,
                                        seg=seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_empty_segments_give_zero_rows_and_zero_key_gradients():
    """Row 0: no text (len_t = 0); row 1: both segments empty -> o = 0,
    L = -1e30 and zero gradients.  Keys in the gap and past each segment get
    exactly zero dk and dv."""
    q, k, v, do = _inputs(n=100, h=2, dh=16, seed=6)
    la, lt = _lens([50, 0], [0, 0])
    seg = 64
    xs = [_t(a, grad=True) for a in (q, k, v)]
    lens2 = _t(np.stack([la, lt], 1))
    o, L = TFA._FlashAttentionFn.apply(*xs, lens2, seg)
    assert torch.all(o[1] == 0) and torch.all(L[1] == TFA.NO_KEY_LSE)
    assert torch.isfinite(L[0]).all()
    want0 = _sdpa(_t(q)[:1], _t(k)[:1], _t(v)[:1], la[:1], lt[:1], seg)
    np.testing.assert_allclose(o[:1].detach().numpy(), want0.numpy(), atol=1e-5)
    dq, dk, dv = torch.autograd.grad((o * _t(do)).sum(), xs)
    assert torch.all(dq[1] == 0) and torch.all(dk[1] == 0) and torch.all(dv[1] == 0)
    assert torch.all(dk[0, :, 50:] == 0) and torch.all(dv[0, :, 50:] == 0)
    assert dk[0, :, :50].abs().max() > 0


def test_trainable_without_grad_runs_the_serving_forward():
    q, k, v, _ = _inputs(n=70, h=2, dh=16, seed=7)
    la, lt = _lens([40, 31], [6, 2])
    with torch.no_grad():
        got = TFA.flash_attention_two_segment_trainable(
            _t(q, grad=True), _t(k), _t(v), _t(la), _t(lt), 50)
    assert got.grad_fn is None
    want = TFA.flash_attention_two_segment(_t(q), _t(k), _t(v), _t(la), _t(lt), 50)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seg,lens", [(71, [[3, 1]]), (-1, [[3, 1]]), (10, [3])],
                         ids=["seg_past_n", "seg_negative", "lens_not_pairs"])
def test_kernel_wrappers_reject_bad_segments(seg, lens):
    """Checked before any launch, so this runs without a card."""
    q = torch.zeros((1, 1, 70, 64))
    with pytest.raises(ValueError, match="seg|lens"):
        TFA.flash_attention_cuda(q, q, q, torch.tensor(lens, dtype=torch.int32), seg)
