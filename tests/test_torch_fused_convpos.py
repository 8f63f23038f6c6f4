"""Port fused ConvPositionEmbedding (ops/fused_convpos.py) against the JAX
package's ``conv_pos_fused``, whose Pallas kernel runs in interpret mode as
the JAX package's own tests run it.  Tolerance atol 1e-4: both sides
compute in fp32 (the Pallas kernel keeps fp32 for fp32 input), differing in
summation order over 31 taps x 64 channels.  The card's fp32 instance
computes each product as three bf16 products (hi.hi + hi.lo + lo.hi of
x, the intermediate and the weights split into bf16 high and low parts); a
torch emulation of that arithmetic is held to the same 1e-4.  Then the
kernel's weight layout, and the serving engine's one-time copy into it."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from f5_tts_tpu.models import layers as JL
from f5_tts_tpu.ops import fused_convpos as JFC
from f5_tts_tpu_torch.infer.api import F5TTS
from f5_tts_tpu_torch.models import layers as TL
from f5_tts_tpu_torch.ops import fused_convpos as TFC


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _case(b, n, d, groups, seed):
    rng = np.random.default_rng(seed)
    p = JL.conv_pos_embed_init(jax.random.PRNGKey(seed), d, kernel_size=31, groups=groups)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    # torch layout [out, in/g, k] from the JAX WIO [k, in/g, out]
    ws = [torch.from_numpy(np.transpose(np.asarray(p[c]["kernel"]), (2, 1, 0)).copy())
          for c in ("conv1", "conv2")]
    bs = [torch.from_numpy(np.array(p[c]["bias"])) for c in ("conv1", "conv2")]
    return p, x, ws, bs


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d,groups,n", [(128, 2, 64), (1024, 16, 64)])
def test_plain_matches_jax_pallas_kernel(interpret, masked, d, groups, n):
    p, x, (w1, w2), (b1, b2) = _case(2, n, d, groups, seed=d)
    lens = np.array([n, n - 20], np.int32) if masked else np.array([n, n], np.int32)
    mask = jnp.asarray(np.arange(n)[None, :] < lens[:, None]) if masked else None
    want = np.asarray(JFC.conv_pos_fused(p, jnp.asarray(x), mask=mask, groups=groups))
    got = TFC.conv_pos_fused(torch.from_numpy(x), w1, b1, w2, b2, torch.from_numpy(lens),
                             groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_intermediate_is_masked_before_row_zero_and_after_len():
    """Rows past len, and the zero padding before row 0, never leak: the
    result equals running each row at its exact length."""
    _, x, (w1, w2), (b1, b2) = _case(1, 48, 128, 2, seed=5)
    xt = torch.from_numpy(x)
    full = TFC.conv_pos_plain(xt, w1, b1, w2, b2, torch.tensor([30], dtype=torch.int32), 2)
    exact = TFC.conv_pos_plain(xt[:, :30], w1, b1, w2, b2, torch.tensor([30], dtype=torch.int32), 2)
    torch.testing.assert_close(full[:, :30], exact, atol=1e-6, rtol=0)
    assert torch.all(full[:, 30:] == 0)


def test_tap_major_layout():
    w = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)  # d=4, groups=2, k=3
    t = TFC.tap_major(w, groups=2)
    assert t.shape == (2, 3, 2, 2)  # [groups][k][c_out][c_in]
    for g in range(2):
        for k in range(3):
            for o in range(2):
                for c in range(2):
                    assert t[g, k, o, c] == w[g * 2 + o, c, k]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_taps_split(dtype):
    """bf16 weights give one bf16 part; fp32 weights a bf16 high part and a
    bf16 low part whose sum is the weight to ~2^-16 relative."""
    w = torch.from_numpy(np.random.default_rng(7).standard_normal((128, 64, 31))
                         .astype(np.float32)).to(dtype)
    t = TFC.kernel_taps(w, 2, dtype)
    assert t.dtype == torch.bfloat16 and t.is_contiguous()
    assert t.shape == ((1 if dtype == torch.bfloat16 else 2), 2, 31, 64, 64)
    ref = TFC.tap_major(w, 2).float()
    got = t.float().sum(0)
    if dtype == torch.bfloat16:
        assert torch.equal(got, ref)
    else:
        assert ((got - ref).abs() <= ref.abs() * 2.0**-16).all()


def _split(t):
    """bf16 (high, low) parts of an fp32 tensor, as the kernel splits them."""
    hi = t.to(torch.bfloat16).double()
    return hi, (t.double() - hi).to(torch.bfloat16).double()


def _mish_jax(x):
    return x * torch.tanh(torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())))


def _emulated_card_fp32(x, w1, b1, w2, b2, lens, groups):
    """Kernel B's fp32 instance: each grouped conv as hi.hi + hi.lo + lo.hi
    of bf16 parts (products exact, sums in double here, fp32 there), bias,
    Mish and masks in fp32."""
    n = x.shape[1]
    m = (torch.arange(n)[None, :] < lens[:, None])[..., None].double()

    def conv(h, w, b):
        (hh, hl), (wh, wl) = _split(h.float()), _split(w.float())
        y = sum(F.conv1d(a.transpose(1, 2), c, padding=15, groups=groups)
                for a, c in ((hh, wh), (hh, wl), (hl, wh)))
        return y.transpose(1, 2) + b.double()

    h = _mish_jax(conv(x.double() * m, w1, b1)) * m
    return _mish_jax(conv(h.float().double(), w2, b2)) * m


@pytest.mark.parametrize("d,groups", [(128, 2), (1024, 16)])
def test_card_fp32_split_products_match_jax_pallas_kernel(interpret, d, groups):
    p, x, (w1, w2), (b1, b2) = _case(2, 64, d, groups, seed=d + 1)
    lens = np.array([64, 44], np.int32)
    mask = jnp.asarray(np.arange(64)[None, :] < lens[:, None])
    want = np.asarray(JFC.conv_pos_fused(p, jnp.asarray(x), mask=mask, groups=groups))
    got = _emulated_card_fp32(torch.from_numpy(x), w1, b1, w2, b2, torch.from_numpy(lens),
                              groups).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_served_request_copies_the_weights_once():
    """The engine makes the kernel's weight layout once, when it casts the
    weights; every ConvPositionEmbedding call of a request gets it, and no
    NFE step copies the weights again."""
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu")
    cpe = tts.engine.model.transformer.input_embed.conv_pos_embed
    assert cpe.taps is not None and all(t.dtype == torch.bfloat16 for t in cpe.taps)
    seen = []
    inner = TL.conv_pos_fused

    def recording(*a, taps=None, **kw):
        seen.append(taps)
        return inner(*a, taps=taps, **kw)

    TL.conv_pos_fused = recording
    try:
        copies = TFC.TAP_COPIES
        wav, _, _ = tts.infer("examples/assets/basic_ref_en.wav",
                              "Some call me nature, others call me mother nature.",
                              "I don't really care what you call me.", nfe_step=4, seed=0,
                              show_info=lambda *a: None)
    finally:
        TL.conv_pos_fused = inner
    assert np.isfinite(wav).all()
    assert len(seen) == 4 and all(t is cpe.taps for t in seen)  # one per NFE step
    assert TFC.TAP_COPIES == copies


def test_cpu_dispatch_does_not_launch():
    _, x, (w1, w2), (b1, b2) = _case(1, 16, 128, 2, seed=6)
    before = TFC.KERNEL.launches
    TFC.conv_pos_fused(torch.from_numpy(x), w1, b1, w2, b2, torch.tensor([16], dtype=torch.int32), 2)
    assert TFC.KERNEL.launches == before

