"""AOT bundles of the Picard sampler (``runtime/aot.py``) on the CPU: a
bundle exported with weights W1 and served with W2 is the live Picard
engine on W2 bitwise, with the same sweeps, at ``picard_tol`` 0 and at
JAX's 1e-3; against JAX's Picard engine on the same weights and noise it
stays within the bound ``tests/test_torch_picard.py`` holds the live
sampler to (``PORT_ATOL``); the meta guards the window and the
tolerance; Picard over a mesh is not exported.

F5TTS_Tiny with the zero-initialized projections filled, NFE 4, W 2.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import json
import os

import numpy as np
import pytest
import torch

from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.runtime.aot import AotEngine, export_engine
from tests.test_torch_aot import CFG, REF_WAV, _mel_inputs, _model, _vocoder
from tests.test_torch_picard import PORT_ATOL

NFE, W = 4, 2
TOLS = (0.0, 1e-3)
SPECS = [("mel", 1, 256, None), ("wav", 1, 256, 256)]


def _opts(tol: float, window: int = W) -> EngineOptions:
    return EngineOptions(nfe_step=NFE, time_parallel_window=window, picard_tol=tol)


def _live(seed: int, tol: float) -> InferenceEngine:
    return InferenceEngine(_model(seed), CFG, vocoder=_vocoder(), options=_opts(tol))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One Picard bundle per tolerance, exported from W1 (seed 0)."""
    out = {}
    for tol in TOLS:
        d = str(tmp_path_factory.mktemp(f"picard_{tol}"))
        export_engine(_live(0, tol), d, SPECS)
        out[tol] = d
    return out


@pytest.fixture(scope="module")
def served(bundles):
    """(bundle engine on W2, live engine on W2) per tolerance."""
    return {tol: (AotEngine(d, _model(5), CFG, vocoder=_vocoder()), _live(5, tol))
            for tol, d in bundles.items()}


def _requests():
    refs, texts, durs = _mel_inputs()
    text = np.random.default_rng(7).integers(0, 200, size=30).astype(np.int32)
    return {"mel": lambda e: e.generate_batch(refs, texts, durs, seeds=[3]),
            "wav": lambda e: e.generate_batch_from_wav(REF_WAV, [text], [220], seeds=[5])}


@pytest.mark.parametrize("entry", ["mel", "wav"])
@pytest.mark.parametrize("tol", TOLS)
def test_w1_picard_bundle_serves_w2_bitwise_the_live_engine(served, tol, entry):
    aot, live = served[tol]
    req = _requests()[entry]
    want = req(live)
    want_sweeps = live.last_sweeps
    got = req(aot)
    np.testing.assert_array_equal(got[0], want[0])  # mel
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)  # wav
    assert got[2] == want[2]
    assert aot.last_sweeps == want_sweeps and 1 <= want_sweeps <= NFE
    if tol == 0.0:  # only the always-exact first entry freezes: one step per sweep
        assert want_sweeps == NFE
    assert not np.array_equal(got[0], req(_live(0, tol))[0])  # W2's audio, not W1's


def test_picard_bundle_runs_no_backbone_forward(served, monkeypatch):
    from f5_tts_tpu_torch.models import dit

    calls = []
    inner = dit.forward
    monkeypatch.setattr(dit, "forward", lambda *a, **k: calls.append(1) or inner(*a, **k))
    monkeypatch.setattr(dit, "forward_cfg", lambda *a, **k: calls.append(1))
    aot, _ = served[0.0]
    _requests()["wav"](aot)
    assert calls == [] and aot.last_sweeps == NFE


def test_picard_bundle_matches_jax_picard_engine(bundles, monkeypatch):
    """The tol-0 bundle on W3 against JAX's Picard ``InferenceEngine`` on W3
    carried over, with JAX's noise for the seed handed to the port."""
    import jax

    from f5_tts_tpu.infer import engine as JE
    from f5_tts_tpu.models.configs import MODEL_CONFIGS as JCONFIGS
    from f5_tts_tpu.utils import ckpt as JCK

    jcfg = JCONFIGS["F5TTS_Tiny"]
    model, voc = _model(3), _vocoder()
    params = JCK.params_from_state(
        {k: v.numpy() for k, v in model.transformer.state_dict().items()}, jcfg.arch)
    vparams = JCK.vocos_params_from_state({k: v.numpy() for k, v in voc.state_dict().items()})

    def jax_noise(seeds, n, d, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(s)), (n, d))) for s in seeds])).to(device)

    monkeypatch.setattr(TE, "draw_noise", jax_noise)
    port = AotEngine(bundles[0.0], model, CFG, vocoder=voc)
    jeng = JE.InferenceEngine(params, jcfg, vocoder_params=vparams, options=JE.EngineOptions(
        nfe_step=NFE, time_parallel_window=W, picard_tol=0.0))
    refs, texts, durs = _mel_inputs()
    got = port.generate_batch(refs, texts, durs, seeds=[3])
    want = jeng.generate_batch(refs, texts, durs, seeds=[3])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=PORT_ATOL)
    assert got[2] == list(want[2])
    for a, b in zip(got[1], want[1]):
        a16, b16 = (np.round(np.asarray(w) * 32767.0).astype(np.int32) for w in (a, b))
        assert a16.shape == b16.shape and np.abs(a16 - b16).max() <= 2


def test_picard_meta_guards_window_and_tolerance(bundles):
    d = bundles[1e-3]
    meta = json.load(open(os.path.join(d, "engine_meta.json")))
    opts = meta["options"]
    assert (opts["time_parallel_window"], opts["picard_tol"]) == (W, 1e-3)
    assert meta["points"]["mel_b1_n256"]["sweep"] == "sweep_b1_n256.pt2"
    refs, texts, durs = _mel_inputs()
    for other in (_opts(0.0), _opts(1e-3, window=4), _opts(1e-3, window=0)):
        eng = AotEngine(d, _model(5), CFG, vocoder=_vocoder(), options=other)
        with pytest.raises(KeyError, match="per-call options"):
            eng.generate_batch(refs, texts, durs, seeds=[3])


def test_picard_over_a_mesh_is_not_exported(bundles, tmp_path):
    eng = AotEngine(bundles[0.0], _model(5), CFG, vocoder=_vocoder())
    with pytest.raises(NotImplementedError, match="one device"):
        eng.enable_time_parallel(object())
    live = _live(0, 0.0)
    live.enable_time_parallel(object())
    with pytest.raises(ValueError, match="one-device engine"):
        export_engine(live, str(tmp_path), SPECS[:1])
