"""Port fused ConvPositionEmbedding (ops/fused_convpos.py) against the JAX
package's ``conv_pos_fused``, whose Pallas kernel runs in interpret mode as
the JAX package's own tests run it.  Tolerance atol 1e-4: both sides
compute in fp32 (the Pallas kernel keeps fp32 for fp32 input), differing in
summation order over 31 taps x 64 channels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import layers as JL
from f5_tts_tpu.ops import fused_convpos as JFC
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
    assert t.shape == (2, 3, 2, 2)  # [groups][k][c_in][c_out]
    for g in range(2):
        for k in range(3):
            for c in range(2):
                for o in range(2):
                    assert t[g, k, c, o] == w[g * 2 + o, c, k]


def test_cpu_dispatch_does_not_launch():
    _, x, (w1, w2), (b1, b2) = _case(1, 16, 128, 2, seed=6)
    before = TFC.KERNEL.launches
    TFC.conv_pos_fused(torch.from_numpy(x), w1, b1, w2, b2, torch.tensor([16], dtype=torch.int32), 2)
    assert TFC.KERNEL.launches == before

