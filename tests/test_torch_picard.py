"""The port's single-device Picard (time-parallel) sampler and
``duplicate_test`` against the JAX package: the cases of
tests/test_time_parallel.py that run on one device, each held against
JAX's ``cfm.sample`` on the same carried-over weights and noise, fp32 on
the CPU.  Picard at tol 0 freezes one exact Euler step per sweep, so it is
the sequential trajectory up to the window's reassociation (JAX's own
bound there: 3e-4)."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from tests.test_dit import SMALL
from tests.test_torch_dit import port_cfg

# Picard against the sequential sampler at tol 0 (tests/test_time_parallel.py)
SEQ_ATOL = 3e-4
# port against JAX at the same options: fp32, the backbones' reassociation
# carried through the steps (test_torch_cfm_vocos's sample bound is a mean
# of 1e-4 over 16 steps)
PORT_ATOL = 1e-4


def _problem(cfg=SMALL, seed=7, b=2, n=48, nt=10):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    lens = np.array([12, 9][:b], np.int32)
    for i, ln in enumerate(lens):
        cond[i, ln:] = 0.0
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    text[-1, 6:] = -1
    duration = np.array([40, 30][:b], np.int32)
    noise = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    return cond, text, duration, noise, lens


def carried(jcfg, tcfg, seed: int):
    """(JAX params, port DiT) with the same weights: the port's seeded init,
    its zero-initialized gates made random, carried into JAX by its own
    loader (which compiles nothing, unlike JAX ``init``)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        dit = TC.CFM(tcfg).transformer.eval().requires_grad_(False)
    randomize_zero_init(dit, torch.Generator().manual_seed(seed + 1))
    return params_from_state({k: v.numpy() for k, v in dit.state_dict().items()}, jcfg), dit


def _opts(mod, **opts):
    """SampleOptions of ``mod`` (JAX's or the port's cfm), with
    tests/test_time_parallel.py's defaults."""
    return mod.SampleOptions(**dict(dict(steps=8, precompute_adaln=False), **opts))


def _port(model, tcfg, args, duplicate_test=False, **opts):
    """(port out, port sweeps) of ``sample``."""
    cond, text, duration, noise, lens = args
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out, info = TC.sample(model, tcfg, *(t(a) for a in (cond, text, duration, noise)),
                          lens=t(lens), opts=_opts(TC, **opts), duplicate_test=duplicate_test,
                          return_info=True)
    return out.numpy(), info["sweeps"]


def _run_both(params, jcfg, model, tcfg, args, duplicate_test=False, **opts):
    """(JAX out, JAX sweeps, port out, port sweeps) of ``sample`` with the
    same SampleOptions fields."""
    cond, text, duration, noise, lens = args
    jout, jinfo = JC.sample(params, jcfg, *(jnp.asarray(a) for a in (cond, text, duration, noise)),
                            lens=jnp.asarray(lens), opts=_opts(JC, **opts), backend="sdpa",
                            duplicate_test=duplicate_test, return_info=True)
    return (np.asarray(jout), int(jinfo["sweeps"]),
            *_port(model, tcfg, args, duplicate_test, **opts))


@pytest.fixture(scope="module")
def small():
    params, model = carried(SMALL, port_cfg(SMALL), seed=2)
    return params, model, port_cfg(SMALL)


def test_picard_tol_zero_is_exact_euler(small):
    params, model, tcfg = small
    args = _problem()
    seq, seq_sweeps = _port(model, tcfg, args)
    want, jsweeps, got, sweeps = _run_both(params, SMALL, model, tcfg, args,
                                           time_parallel_window=4, picard_tol=0.0)
    assert sweeps == jsweeps == seq_sweeps == 8  # one frozen step per sweep at tol 0
    np.testing.assert_allclose(got, seq, atol=SEQ_ATOL)
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


@pytest.mark.parametrize("steps,w,want", [(8, 4, 2), (7, 4, 2), (8, 3, 3), (6, 8, 1)])
def test_picard_huge_tol_advances_full_windows(small, steps, w, want):
    """tol = inf accepts every window entry: ceil(steps / W) sweeps."""
    params, model, tcfg = small
    jout, jsweeps, got, sweeps = _run_both(params, SMALL, model, tcfg, _problem(seed=9),
                                           steps=steps, time_parallel_window=w,
                                           picard_tol=float("inf"))
    assert sweeps == jsweeps == want
    np.testing.assert_allclose(got, jout, atol=PORT_ATOL)


def test_picard_tolerance_bounds_drift(small):
    """tol 1e-3 early-accepts tail entries: within O(steps tol) of the
    sequential trajectory, in the same number of sweeps as JAX."""
    params, model, tcfg = small
    args = _problem(seed=11)
    seq, _ = _port(model, tcfg, args, steps=16)
    want, jsweeps, got, sweeps = _run_both(params, SMALL, model, tcfg, args, steps=16,
                                           time_parallel_window=8, picard_tol=1e-3)
    assert sweeps == jsweeps <= 16
    assert np.sqrt(np.mean((got - seq) ** 2)) < 60 * 1e-3
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


def test_picard_precomputed_adaln_tables_match(small):
    """The window's per-row AdaLN tables (doubled with the CFG rows) against
    the window without them, the sequential sampler and JAX."""
    params, model, tcfg = small
    args = _problem(seed=23)
    plain, _ = _port(model, tcfg, args, time_parallel_window=4, picard_tol=0.0)
    want, _, tabled, _ = _run_both(params, SMALL, model, tcfg, args, time_parallel_window=4,
                                   picard_tol=0.0, precompute_adaln=True)
    np.testing.assert_allclose(tabled, plain, atol=SEQ_ATOL)
    seq, _ = _port(model, tcfg, args, precompute_adaln=True)
    np.testing.assert_allclose(tabled, seq, atol=5e-4)
    np.testing.assert_allclose(tabled, want, atol=PORT_ATOL)


def test_picard_no_cfg_path(small):
    params, model, tcfg = small
    args = _problem(seed=13)
    seq, _ = _port(model, tcfg, args, steps=6, cfg_strength=0.0)
    want, _, got, _ = _run_both(params, SMALL, model, tcfg, args, steps=6, cfg_strength=0.0,
                                time_parallel_window=3, picard_tol=0.0)
    np.testing.assert_allclose(got, seq, atol=SEQ_ATOL)
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


@pytest.mark.parametrize("family", ["unett", "mmdit"])
def test_picard_other_backbones(family):
    """UNetT (time as a token) and MMDiT (two streams, the tiled c_mask) at
    tol 0 against their sequential samplers and JAX."""
    if family == "unett":
        from tests.test_torch_unett import SMALL as JCFG
        from tests.test_torch_unett import carried as carry
        from tests.test_torch_unett import port_cfg as pcfg

        params, model = carry(JCFG, seed=5)
    else:
        from tests.test_torch_mmdit import SMALL as JCFG
        from tests.test_torch_mmdit import carried as carry
        from tests.test_torch_mmdit import port_cfg as pcfg

        params, cfm = carry(JCFG, seed=5)
        model = cfm.transformer
    args = _problem(JCFG, seed=29)
    seq, _ = _port(model, pcfg(JCFG), args, steps=4)
    want, _, got, sweeps = _run_both(params, JCFG, model, pcfg(JCFG), args, steps=4,
                                     time_parallel_window=4, picard_tol=0.0)
    assert sweeps == 4
    np.testing.assert_allclose(got, seq, atol=SEQ_ATOL)
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


@pytest.mark.parametrize("t_start", [0.25, 0.5])
def test_duplicate_test_matches_jax(small, t_start):
    """``duplicate_test``: y0 blends a copy of the reference shifted past
    it, and the ODE runs int(steps (1 - t_start)) steps from t_start;
    sequential and Picard alike."""
    params, model, tcfg = small
    args = _problem(seed=31)
    want, jsteps, got, steps = _run_both(params, SMALL, model, tcfg, args, duplicate_test=True,
                                         steps=16, t_start=t_start)
    assert steps == jsteps == int(16 * (1 - t_start))
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)
    want, _, got, sweeps = _run_both(params, SMALL, model, tcfg, args, duplicate_test=True,
                                     steps=16, t_start=t_start, time_parallel_window=4,
                                     picard_tol=0.0)
    assert sweeps == steps
    np.testing.assert_allclose(got, want, atol=PORT_ATOL)


def test_schedule_with_t_start_equals_jax():
    for steps, t0 in ((12, 0.25), (8, 0.5), (32, 0.0)):
        np.testing.assert_array_equal(TC.timestep_schedule(steps, -1.0, True, t0),
                                      JC.timestep_schedule(steps, -1.0, True, t0))


def test_engine_time_parallel_option():
    """``EngineOptions(time_parallel_window=2, picard_tol=0)``: the engine's
    sampling function against JAX's ``_sample_and_decode`` with the same
    option and the noise JAX draws for the seed; then the port's engine
    (on the CPU: the module-level functions) against its sequential self."""
    import jax

    from f5_tts_tpu.infer import engine as JE
    from f5_tts_tpu.models.configs import MODEL_CONFIGS as JCONFIGS
    from f5_tts_tpu_torch.infer import engine as TE
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.utils.ckpt import load_into

    jcfg, tcfg = JCONFIGS["F5TTS_Tiny"], MODEL_CONFIGS["F5TTS_Tiny"]
    params, dit = carried(jcfg.arch, tcfg.arch, seed=4)
    rng = np.random.default_rng(3)
    n, n_ref = 256, 40
    ref = rng.standard_normal((n_ref, 100)).astype(np.float32)
    ids = rng.integers(0, 200, size=30).astype(np.int32)
    cond = np.zeros((1, n, 100), np.float32)
    cond[0, :n_ref] = ref
    text = np.full((1, n), -1, np.int32)
    text[0, :30] = ids
    lens, duration = np.array([n_ref], np.int32), np.array([200], np.int32)
    kw = dict(nfe_step=4, time_parallel_window=2, picard_tol=0.0)
    want, _ = JE._sample_and_decode(params, None, jcfg, JE.EngineOptions(**kw),
                                    *(jnp.asarray(a) for a in (cond, text, lens, duration)),
                                    jnp.asarray(np.array([5], np.int32)), decode=False)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n, 100)))[None]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got, _ = TE.sample_and_decode(dit, None, tcfg, TE.EngineOptions(**kw), t(cond), t(text),
                                  t(lens), t(duration), t(noise), decode=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PORT_ATOL)

    mels = {}
    for w in (0, 2):
        model = CFM(tcfg.arch)
        load_into(model.transformer, dit.state_dict())
        eng = TE.InferenceEngine(model, tcfg, options=TE.EngineOptions(
            nfe_step=4, time_parallel_window=w, picard_tol=0.0))
        mels[w] = eng.generate_batch([ref], [ids], [200], seeds=[0])[0]
    np.testing.assert_allclose(mels[2], mels[0], atol=SEQ_ATOL)
