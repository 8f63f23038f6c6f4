"""The two experiment kernels' plain versions against the JAX experiments.

``f5_tts_tpu_torch/scripts/exp_pipelined_flash.py`` (kernel H) computes
kernel A's function, and its plain version is kernel A's
(``flash_attention_plain``); it is held against JAX ``_flash_pipe``
(``scripts/exp_pipelined_flash.py``), the Pallas kernel in interpret mode,
which rounds q (prescaled), k, v and the probabilities to bf16 where the
plain version computes in fp32: tolerances as tests/test_flash_attention.py,
2e-2 max and 2e-3 mean absolute error.

``f5_tts_tpu_torch/scripts/exp_fused_ln_matmul.py`` (kernel I): its plain
version is JAX ``xla_ref`` in PyTorch, and equals it to bf16 rounding (one
bf16 step of the output where a summation order tips a rounding: max error
2e-2 of the largest output, mean 1e-3); against JAX ``fused_ln_matmul``
(interpret mode, bias added before the one rounding) likewise.

The JAX scripts are loaded from their paths; both call
``enable_persistent_cache()`` at import, which is replaced by a no-op so
that the test worker's JAX compilation cache stays where it is.

The timing-only variants of kernel H that
``f5_tts_tpu_torch/scripts/exp_pipelined_flash_variants.py`` builds on the
card must each apply to the committed kernel source.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu_torch.scripts import exp_fused_ln_matmul as XI
from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_script(name):
    import f5_tts_tpu.utils.compile_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_persistent_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    return mod


@pytest.fixture(scope="module")
def jax_pipe():
    return _load_jax_script("exp_pipelined_flash")


@pytest.fixture(scope="module")
def jax_ln():
    return _load_jax_script("exp_fused_ln_matmul")


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _bf16(rng, shape, scale=1.0):
    """fp32 values that bf16 holds exactly."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("lens", [[256, 256], [256, 57]])
def test_flash_pipe_plain_matches_jax(jax_pipe, lens):
    rng = np.random.default_rng(sum(lens))
    b, h, n, dh = 2, 2, 256, 64
    q, k, v = (_bf16(rng, (b, h, n, dh)) for _ in range(3))
    lens_np = np.array(lens, np.int32)
    want = np.asarray(jax_pipe._flash_pipe(*(jnp.asarray(a) for a in (q, k, v, lens_np)),
                                           block_q=128, block_k=64)).astype(np.float32)
    got = XH.flash_pipe(*(torch.from_numpy(a) for a in (q, k, v, lens_np))).numpy()
    err = np.abs(got - want)
    assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())


def test_flash_pipe_dispatch_refuses_what_kernel_h_does_not_take():
    q = torch.zeros((1, 1, 8, 64))
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        XH.flash_pipe_cuda(q, q, q, lens)
    with pytest.raises(ValueError, match="block_q"):
        XH.flash_pipe_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16(), lens, 32, 64)


def test_kernel_h_variants_apply_to_its_source():
    """The timing-only variants of kernel H (exp_pipelined_flash_variants)
    are edits of the committed source: each must find what it edits, and
    change it, so that the card run measures what PERF.md says it does."""
    from f5_tts_tpu_torch.ops.cuda_build import CSRC_DIR
    from f5_tts_tpu_torch.scripts import exp_pipelined_flash_variants as XV

    with open(os.path.join(CSRC_DIR, "flash_attention_pipelined.cu")) as f:
        src = f.read()
    vs = XV.variants(src)
    assert vs["kernel"] == src
    assert len(set(vs.values())) == len(vs)
    assert vs["trace"].count("clock64()") == len(XV.STEP_PHASES) + 1
    assert "(BAR_TURN" not in vs["no_pingpong"] and "exp2_cubic(x)" not in vs["no_exp2"]
    assert "step(sa, sb, j)" not in vs["fa3_order"] and vs["fa3_order"].count("fa3_step<") == 3


def _ln_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (m, k)), _bf16(rng, (k, n), 0.02),
            (rng.standard_normal((1, n)) * 0.01).astype(np.float32),
            (1 + rng.standard_normal((1, k)) * 0.1).astype(np.float32),
            (rng.standard_normal((1, k)) * 0.1).astype(np.float32))


def _to_jax(args):
    x, w, bias, sc, sh = args
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
            jnp.asarray(sc), jnp.asarray(sh))


def _to_torch(args):
    x, w, bias, sc, sh = (torch.from_numpy(a) for a in args)
    return x.bfloat16(), w.bfloat16(), bias, sc, sh


def _close(got, want, rel_max=2e-2, mean=1e-3):
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() <= rel_max and np.abs(got - want).mean() <= mean, (err.max(),
                                                                         np.abs(got - want).mean())


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (96, 256, 128)])
def test_fused_ln_matmul_plain_matches_jax(jax_ln, m, k, n):
    args = _ln_inputs(m, k, n, seed=m + n)
    got = XI.fused_ln_matmul(*_to_torch(args))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    ref = np.asarray(jax_ln.xla_ref(*_to_jax(args))).astype(np.float32)
    _close(got, ref)
    fused = np.asarray(jax_ln.fused_ln_matmul(*_to_jax(args), bm=32, bn=128)).astype(np.float32)
    _close(got, fused)


def test_unfused_composition_matches_plain():
    """The timing yardstick computes the same function."""
    args = _to_torch(_ln_inputs(48, 128, 64, seed=3))
    _close(XI.unfused(*args).float().numpy(), XI.fused_ln_matmul_plain(*args).float().numpy())


def test_fused_ln_matmul_dispatch_refuses_what_kernel_i_does_not_take():
    x, w, bias, sc, sh = _to_torch(_ln_inputs(8, 32, 16, seed=4))
    with pytest.raises(TypeError):
        XI.fused_ln_matmul_cuda(x.float(), w, bias, sc, sh)
    with pytest.raises(ValueError, match="bias"):
        XI.fused_ln_matmul_cuda(x, w, bias[0], sc, sh)
