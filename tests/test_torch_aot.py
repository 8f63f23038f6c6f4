"""AOT serving bundles of the port (``runtime/aot.py``) on the CPU, as
``tests/test_aot.py`` holds the JAX package's: export once, load with no
model tracing, match the live engine.

F5TTS_Tiny with its zero-initialized AdaLN gates, final norm and
``proj_out`` randomized (zero gates make every block the identity and the
outputs independent of the weights).  The exported programs reproduce the
live CPU engine bitwise in mel and wav; the tests assert JAX's tolerance
(atol 1e-5) and bitwise equality both.  Against the JAX engine the AOT
path is held to the slice tests' bounds (``tests/test_torch_slice.py``):
mel MAE < 1e-3, int16 wav within 2 steps.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.infer.api import F5TTS, _seeded
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.runtime import aot
from f5_tts_tpu_torch.runtime.aot import AotEngine, export_engine

CFG = MODEL_CONFIGS["F5TTS_Tiny"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (256, 512)


def _model(seed: int) -> CFM:
    """Seeded F5TTS_Tiny weights with the zero-initialized projections filled."""
    m = _seeded(lambda: CFM(CFG.arch), seed)
    randomize_zero_init(m.transformer, torch.Generator().manual_seed(seed))
    return m


def _vocoder():
    return _seeded(Vocos, 1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A bundle from the build CLI (F5TTS_Tiny, NFE 2, mel and wav at b1,
    bucket 256, ref bucket 256, on the CPU), and the live engine on weights
    W1 (seed 0).  The programs hold no weights, so the bundle serves W1 as
    well as the CLI's own seeded weights."""
    out = str(tmp_path_factory.mktemp("cli") / "art")
    aot.main(["--out", out, "--model", "F5TTS_Tiny", "--device", "cpu", "--batches", "1",
              "--buckets", "256", "--ref-buckets", "256", "--nfe", "2"])
    eng = InferenceEngine(_model(0), CFG, vocoder=_vocoder(), options=EngineOptions(nfe_step=2))
    return eng, out, ["mel_b1_n256", "wav_b1_n256_r256"]


@pytest.fixture(scope="module")
def loaded(built):
    """The bundle loaded with W1."""
    _, out, _ = built
    return AotEngine(out, _model(0), CFG, vocoder=_vocoder())


def _mel_inputs(b=1, seed=0):
    rng = np.random.default_rng(seed)
    refs = [rng.standard_normal((40 + 5 * i, CFG.mel.n_mel_channels)).astype(np.float32)
            for i in range(b)]
    texts = [rng.integers(0, 200, size=24 + i).astype(np.int32) for i in range(b)]
    durs = [200 + 10 * i for i in range(b)]
    return refs, texts, durs


REF_WAV = (0.2 * np.sin(np.arange(24000) / 30.0)).astype(np.float32)


def _same(got, want):
    """JAX's tolerance, and bitwise equality."""
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, want)


def test_aot_matches_live_engine_mel_path(built, loaded):
    eng, out, names = built
    assert json.load(open(os.path.join(out, "engine_meta.json")))["artifacts"] == names
    refs, texts, durs = _mel_inputs()
    want = eng.generate_batch(refs, texts, durs, seeds=[3])
    got = loaded.generate_batch(refs, texts, durs, seeds=[3])
    _same(got[0], want[0])  # mel
    for a, b_ in zip(got[1], want[1]):
        _same(a, b_)  # wav
    assert got[2] == want[2]


def test_aot_matches_live_engine_wav_path(built, loaded):
    eng, _, _ = built
    text = np.random.default_rng(7).integers(0, 200, size=30).astype(np.int32)
    want = eng.generate_batch_from_wav(REF_WAV, [text], [220], seeds=[5])
    got = loaded.generate_batch_from_wav(REF_WAV, [text], [220], seeds=[5])
    _same(got[0], want[0])
    _same(got[1][0], want[1][0])


def test_aot_runs_no_backbone_forward(loaded, monkeypatch):
    """A served call runs the exported programs only: no Python forward."""
    from f5_tts_tpu_torch.models import dit

    calls = []
    inner = dit.forward
    monkeypatch.setattr(dit, "forward", lambda *a, **k: calls.append(1) or inner(*a, **k))
    refs, texts, durs = _mel_inputs()
    mels, _, _ = loaded.generate_batch(refs, texts, durs, seeds=[3])
    assert np.isfinite(mels).all() and calls == []


def test_aot_unexported_shape_raises_or_falls_back(built, loaded):
    _, out, _ = built
    refs, texts, durs = _mel_inputs(b=1)
    durs = [400]  # bucket 512: not exported
    with pytest.raises(KeyError, match="no AOT artifact"):
        loaded.generate_batch(refs, texts, durs, seeds=[1])
    loaded.fallback = True  # as AotEngine(..., fallback=True) builds it
    try:
        mels, wavs, gf = loaded.generate_batch(refs, texts, durs, seeds=[1])
    finally:
        loaded.fallback = False
    assert wavs and np.isfinite(wavs[0]).all()


def test_aot_meta_guards_model_identity(built):
    _, out, _ = built
    wrong = dataclasses.replace(CFG, name="SomethingElse")
    with pytest.raises(ValueError, match="artifacts built for"):
        AotEngine(out, _model(0), wrong, vocoder=_vocoder())


def test_aot_options_come_from_meta(built, loaded):
    eng, out, _ = built
    assert loaded.options == eng.options  # nfe etc. restored from engine_meta.json
    assert loaded.dtype == eng.dtype and loaded.buckets == TE.DEFAULT_BUCKETS
    meta = json.load(open(os.path.join(out, "engine_meta.json")))
    assert meta["torch_version"] == torch.__version__
    assert meta["kernel_digest"] == cuda_build.LIBRARY.digest()
    # a prelude per point; one step and one epilogue serve both points of (b, n)
    assert sorted(meta["programs"]) == sorted(f for f in os.listdir(out) if f.endswith(".pt2"))
    assert sorted(meta["programs"]) == ["epilogue_b1_n256.pt2", "prelude_mel_b1_n256.pt2",
                                        "prelude_wav_b1_n256_r256.pt2", "step_b1_n256.pt2"]


def test_bundle_holds_no_weights(built):
    """Weights are arguments: no program keeps a parameter or its example
    inputs, and its constants are the config's tables, none of a weight's
    shape."""
    eng, out, _ = built
    shapes = {tuple(p.shape) for p in eng.model.parameters()}
    shapes |= {tuple(p.shape) for p in eng.vocoder.parameters()}
    meta = json.load(open(os.path.join(out, "engine_meta.json")))
    for fname, info in meta["programs"].items():
        ep = torch.export.load(os.path.join(out, fname))
        assert not ep.state_dict, fname
        consts = {k: tuple(v.shape) for k, v in ep.constants.items()}
        assert not set(consts.values()) & shapes, (fname, consts)
    total = aot.bundle_bytes(out)
    weights = sum(p.numel() * p.element_size() for p in eng.model.parameters())
    assert total < weights + 40e6  # the config tables (STFT bases, rotary table)


def test_w1_bundle_serves_w2_weights(built):
    """A bundle built with W1 and loaded with W2 equals the live engine on
    W2, and differs from W1's live output."""
    eng1, out, _ = built
    eng2 = InferenceEngine(_model(7), CFG, vocoder=_vocoder(), options=EngineOptions(nfe_step=2))
    aot2 = AotEngine(out, _model(7), CFG, vocoder=_vocoder())
    refs, texts, durs = _mel_inputs()
    want = eng2.generate_batch(refs, texts, durs, seeds=[3])
    got = aot2.generate_batch(refs, texts, durs, seeds=[3])
    _same(got[0], want[0])
    for a, b_ in zip(got[1], want[1]):
        _same(a, b_)
    w1 = eng1.generate_batch(refs, texts, durs, seeds=[3])
    assert np.abs(got[0] - w1[0]).mean() > 1e-2


def test_aot_w8a8_bundle_matches_live_engine(tmp_path):
    """W8A8 (kernel G's op), two rows: the int8 weights and scales are
    arguments too (built with W1, served with W2)."""
    opts = EngineOptions(nfe_step=2, quantize=True)
    eng = InferenceEngine(_model(0), CFG, vocoder=_vocoder(), options=opts, buckets=BUCKETS)
    export_engine(eng, str(tmp_path), [("mel", 2, 256, None)])
    eng2 = InferenceEngine(_model(3), CFG, vocoder=_vocoder(), options=opts, buckets=BUCKETS)
    got_aot = AotEngine(str(tmp_path), _model(3), CFG, vocoder=_vocoder())
    assert got_aot.options.quantize
    refs, texts, durs = _mel_inputs(b=2)
    want = eng2.generate_batch(refs, texts, durs, seeds=[3, 4])
    got = got_aot.generate_batch(refs, texts, durs, seeds=[3, 4])
    _same(got[0], want[0])
    for a, b_ in zip(got[1], want[1]):
        _same(a, b_)


def _copy_bundle(src, dst, **meta_changes):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "engine_meta.json")
    meta = json.load(open(path))
    meta.update(meta_changes)
    json.dump(meta, open(path, "w"))
    return dst


def test_torch_version_or_kernel_digest_mismatch_raises(built, tmp_path):
    _, out, _ = built
    old = _copy_bundle(out, str(tmp_path / "old_torch"), torch_version="2.0.0")
    with pytest.raises(RuntimeError, match="exported by torch 2.0.0"):
        AotEngine(old, _model(0), CFG, vocoder=_vocoder())
    stale = _copy_bundle(out, str(tmp_path / "stale"), kernel_digest="0" * 16)
    with pytest.raises(RuntimeError, match="kernel sources"):
        AotEngine(stale, _model(0), CFG, vocoder=_vocoder())


def test_stale_or_missing_bundle_kernels_raise(built, tmp_path):
    """A ``kernels/`` directory of other sources, or one missing a library,
    raises at load: nothing is rebuilt, nothing drops to a plain path."""
    _, out, _ = built
    stale = _copy_bundle(out, str(tmp_path / "stale"))
    os.makedirs(os.path.join(stale, "kernels", "0" * 16))
    with pytest.raises(RuntimeError, match="do not match these sources"):
        AotEngine(stale, _model(0), CFG, vocoder=_vocoder())
    part = _copy_bundle(out, str(tmp_path / "part"))
    kdir = os.path.join(part, "kernels", cuda_build.LIBRARY.digest())
    os.makedirs(kdir)
    open(os.path.join(kdir, "libflash_attention.so"), "wb").close()
    with pytest.raises(RuntimeError, match="no library for"):
        AotEngine(part, _model(0), CFG, vocoder=_vocoder())
    assert cuda_build.LIBRARY.prebuilt is None


def test_warm_artifacts_packages_and_loads_without_nvcc(tmp_path, monkeypatch):
    """``warm_artifacts`` copies a library's built ``.so`` files into the
    bundle; ``use_prebuilt`` then serves them with no build.  Checked on a
    library of stand-in sources (the CPU has no nvcc)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    lib = cuda_build.KernelLibrary(str(csrc), str(build))
    os.makedirs(build / lib.digest())
    for name in ("liba.so", "libb.so"):
        (build / lib.digest() / name).write_bytes(b"\0")
    bundle = tmp_path / "bundle"
    assert aot.warm_artifacts(str(bundle), library=lib) == 2
    assert sorted(os.listdir(bundle / "kernels" / lib.digest())) == ["liba.so", "libb.so"]

    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: pytest.fail("nvcc looked up"))
    fresh = cuda_build.KernelLibrary(str(csrc), str(tmp_path / "empty"))
    path = fresh.use_prebuilt(str(bundle / "kernels"))
    assert fresh.build() == path and fresh.build_seconds is None
    (csrc / "a.cu").write_text("// edited\n")  # other sources: another digest
    with pytest.raises(RuntimeError, match="do not match"):
        cuda_build.KernelLibrary(str(csrc), str(build)).use_prebuilt(str(bundle / "kernels"))


def test_f5tts_api_serves_from_artifacts(built):
    """F5TTS(artifacts=dir) serves through an AotEngine and gives the live
    F5TTS's audio; a per-call option the bundle does not hold raises."""
    _, cli_bundle, _ = built
    live = F5TTS(model="F5TTS_Tiny", init_random=True, nfe_step=2, device="cpu")
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", artifacts=cli_bundle)
    assert isinstance(tts.engine, AotEngine) and tts.engine.options.nfe_step == 2
    sr = live.target_sample_rate
    ref = (0.2 * np.sin(np.arange(sr) / 25.0)).astype(np.float32)
    kw = dict(ref_file=(ref, sr), ref_text="a tone reference.",
              gen_text="artifact serving check.", seed=11, nfe_step=2,
              show_info=lambda *a, **k: None)
    wav_live, _, _ = live.infer(**kw)
    wav_aot, _, _ = tts.infer(**kw)
    _same(wav_aot, wav_live)
    with pytest.raises(KeyError, match="per-call options"):
        tts.infer(**{**kw, "nfe_step": 4})
    tts.engine.fallback = True  # as F5TTS(..., artifacts_fallback=True) builds it
    wav4, _, _ = tts.infer(**{**kw, "nfe_step": 4})
    assert np.isfinite(wav4).all()


def test_fresh_process_serves_with_no_forward_and_no_nvcc(built, tmp_path):
    """A fresh process loads the bundle and serves: no backbone ``forward``
    runs, ``nvcc`` is never looked up and no kernel is built."""
    _, cli_bundle, _ = built
    script = textwrap.dedent(f"""
        import numpy as np
        from f5_tts_tpu_torch.models import dit
        from f5_tts_tpu_torch.ops import cuda_build

        calls = {{"forward": 0, "nvcc": 0}}
        inner = dit.forward

        def counted(*a, **k):
            calls["forward"] += 1
            return inner(*a, **k)

        def no_nvcc():
            calls["nvcc"] += 1
            raise RuntimeError("nvcc hidden")

        dit.forward = counted
        cuda_build.find_nvcc = no_nvcc
        from f5_tts_tpu_torch.infer.api import _seeded
        from f5_tts_tpu_torch.models.cfm import CFM
        from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
        from f5_tts_tpu_torch.models.vocos import Vocos
        from f5_tts_tpu_torch.runtime.aot import AotEngine

        cfg = MODEL_CONFIGS["F5TTS_Tiny"]
        eng = AotEngine({cli_bundle!r}, _seeded(lambda: CFM(cfg.arch), 0), cfg,
                        vocoder=_seeded(Vocos, 1))
        ref = (0.2 * np.sin(np.arange(24000) / 25.0)).astype(np.float32)
        _, wavs, _ = eng.generate_batch_from_wav(ref, [np.arange(30, dtype=np.int32)], [200],
                                                 seeds=[11])
        assert np.isfinite(wavs[0]).all()
        assert calls == {{"forward": 0, "nvcc": 0}}, calls
        assert cuda_build.LIBRARY.build_seconds is None
        print("OK no forward, no nvcc")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP", "PYTHONPATH")}
    env["F5TTS_KERNEL_BUILD_DIR"] = str(tmp_path / "empty_build")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "OK no forward, no nvcc" in r.stdout


def test_aot_slice_matches_jax_engine(built, monkeypatch):
    """The slice as a whole: the bundle loaded with weights W3 serves what
    JAX's ``InferenceEngine`` serves on W3 carried over to it
    (``params_from_state``), with the same noise (JAX's draws, handed to
    the port)."""
    import jax

    from f5_tts_tpu.infer import engine as JE
    from f5_tts_tpu.utils import ckpt as JCK
    from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS

    _, out, _ = built
    jcfg = JAX_CONFIGS["F5TTS_Tiny"]
    # the port's seeded weights carried into JAX (JAX's init compiles for seconds)
    model, voc = _model(3), _vocoder()
    params = JCK.params_from_state(
        {k: v.numpy() for k, v in model.transformer.state_dict().items()}, jcfg.arch)
    vparams = JCK.vocos_params_from_state({k: v.numpy() for k, v in voc.state_dict().items()})

    def jax_noise(seeds, n, d, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(s)), (n, d))) for s in seeds])).to(device)

    monkeypatch.setattr(TE, "draw_noise", jax_noise)
    port = AotEngine(out, model, CFG, vocoder=voc)
    jeng = JE.InferenceEngine(params, jcfg, vocoder_params=vparams,
                              options=JE.EngineOptions(nfe_step=2))
    refs, texts, durs = _mel_inputs()
    got = port.generate_batch(refs, texts, durs, seeds=[3])
    want = jeng.generate_batch(refs, texts, durs, seeds=[3])
    mae = np.abs(got[0] - np.asarray(want[0])).mean()
    assert mae < 1e-3, mae
    assert got[2] == list(want[2])
    for a, b_ in zip(got[1], want[1]):
        a16, b16 = (np.round(np.asarray(w) * 32767.0).astype(np.int32) for w in (a, b_))
        assert a16.shape == b16.shape and np.abs(a16 - b16).max() <= 2
