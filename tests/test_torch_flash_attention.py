"""Port flash attention (ops/flash_attention.py) against the JAX package.

The JAX ``flash_attention`` runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU.  The port's plain version is the
one a CPU tensor dispatches to; the CUDA kernel is checked against it on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.ops import flash_attention as JFA
from f5_tts_tpu.ops.attention import sdpa as jax_sdpa
from f5_tts_tpu_torch.ops import attention as TA
from f5_tts_tpu_torch.ops import flash_attention as TFA


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(b, h, n, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n", [256, 768])
def test_plain_matches_jax_pallas_kernel(interpret, n):
    """Tolerance atol 2e-2 and mean < 2e-3, as tests/test_flash_attention.py:
    the Pallas kernel rounds q (prescaled) and p to bf16; the port's plain
    version is exact fp32."""
    q, k, v = _qkv(2, 4, n)
    lens = np.array([n, n - 37], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    want = np.asarray(JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(mask)))
    got = TFA.flash_attention_plain(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    assert np.abs(got - want).mean() < 2e-3


@pytest.mark.parametrize("n", [256, 300])
def test_plain_matches_jax_sdpa_fp32(n):
    """Same math in fp32 on both sides: atol 1e-5 on every row (all query
    rows are valid; only keys are masked)."""
    q, k, v = _qkv(2, 4, n, seed=1)
    lens = np.array([n, n - 37], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = TFA.flash_attention_plain(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    sd = TA.sdpa(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(sd, want, atol=1e-5)


def test_row_with_no_valid_key_gives_zero():
    q, k, v = _qkv(2, 2, 64, seed=2)
    out = TFA.flash_attention_plain(_t(q), _t(k), _t(v), torch.tensor([0, 64], dtype=torch.int32))
    assert torch.all(out[0] == 0)
    assert torch.isfinite(out).all() and out[1].abs().max() > 0


def test_auto_backend_on_cpu_runs_plain_version_without_launching():
    q, k, v = (_t(a) for a in _qkv(1, 2, 128, seed=3))
    mask = torch.arange(128)[None, :] < 100
    before = TFA.KERNEL.launches
    got = TA.attention(q, k, v, mask=mask, backend="auto")
    assert TFA.KERNEL.launches == before
    want = TFA.flash_attention_plain(q, k, v, torch.tensor([100], dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        TA.attention(q, k, v, mask=mask, backend="chunked")

