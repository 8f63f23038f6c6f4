"""Port UNetT (models/unett.py; E2-TTS) against the JAX package with
carried-over weights, and its path through the CFM sampler, the checkpoint
loaders, the YAML config and the Trainer.

Both sides hold the same random weights for tests/test_unett.py's
``SMALL``: the port's seeded module init (UNetT zero-initializes nothing,
so the output is not trivially zero), read into the JAX parameter tree by
the JAX package's own loader ``unett_params_from_state`` (``unett.init``
would compile its random draws for longer than these tests run);
``state_from_jax_params`` maps that tree back exactly.  Everything runs in fp32
on the CPU: JAX through ``backend="sdpa"``, the port through the plain
versions of its kernels (``backend="auto"``).  Tolerance atol 1e-4: the
same fp32 math summed in another order across a few layers.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models import unett as JU
from f5_tts_tpu.utils.ckpt import unett_params_from_state
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.models import unett as TU
from f5_tts_tpu_torch.models.configs import (MODEL_CONFIGS, ModelConfig, UNetTConfig,
                                             from_yaml_dict, to_yaml_dict)
from f5_tts_tpu_torch.train import cli as TCLI
from f5_tts_tpu_torch.utils import ckpt as TK
from tests.test_unett import SMALL

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(cfg):
    names = {f.name for f in dataclasses.fields(UNetTConfig)}
    return UNetTConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def carried(cfg, seed=0):
    """(JAX params, port UNetT) holding the same seeded random weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TC.CFM(port_cfg(cfg)).eval().requires_grad_(False)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return unett_params_from_state(state, cfg), model.transformer


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, b=2, n=24, nt=9, seed=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 5:] = -1
    time = np.array([0.2, 0.8], np.float32)
    mask = np.arange(n)[None, :] < np.array([[n], [n - 7]])
    return x, cond, text, time, mask


@pytest.fixture(scope="module")
def small():
    return carried(SMALL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_forward_matches_jax(small, use_mask):
    params, model = small
    x, cond, text, time, mask = _inputs(SMALL)
    m = mask if use_mask else None
    want = JU.forward_with_text(params, SMALL, jnp.asarray(x), jnp.asarray(cond),
                                jnp.asarray(text), jnp.asarray(time),
                                mask=None if m is None else jnp.asarray(m), backend="sdpa")
    got = TU.forward_with_text(model, port_cfg(SMALL), _t(x), _t(cond), _t(text), _t(time),
                               mask=None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forward_cfg_and_fused_qkv_match_jax():
    params, model = carried(SMALL, seed=1)
    # one row: the fused CFG batch then has the forward test's shapes, whose
    # JAX ops are compiled already
    x, cond, text, time, mask = (a[1:] for a in _inputs(SMALL))
    te_c = JU.text_embedding(params, SMALL, jnp.asarray(text), 24)
    te_u = JU.text_embedding(params, SMALL, jnp.asarray(text), 24, drop_text=True)
    want = JU.forward_cfg(params, SMALL, jnp.asarray(x), jnp.asarray(cond), te_c, te_u,
                          jnp.asarray(time), mask=jnp.asarray(mask), backend="sdpa")
    pc = port_cfg(SMALL)
    tc = TU.text_embedding(model, pc, _t(text), 24)
    tu = TU.text_embedding(model, pc, _t(text), 24, drop_text=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(te_c), atol=ATOL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(te_u), atol=ATOL)
    keys = set(model.state_dict())
    TU.fuse_for_inference(model)  # the serving transform keeps outputs and names
    assert set(model.state_dict()) == keys
    got = TU.forward_cfg(model, pc, _t(x), _t(cond), tc, tu, _t(time), mask=_t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("variant", ["add", "beyond_max_pos"])
def test_add_skip_and_rope_past_max_pos_match_jax(variant):
    """The ``add`` skip variant, and n + 1 tokens past ``max_pos``: the
    rotary table must cover them.  SMALL's widths, so the JAX ops compiled
    for the forward test serve here too."""
    if variant == "add":
        cfg = dataclasses.replace(SMALL, skip_connect_type="add")
    else:
        cfg = dataclasses.replace(SMALL, max_pos=20, conv_layers=0)
    params, model = carried(cfg, seed=2)
    x, cond, text, time, mask = _inputs(cfg)
    want = JU.forward_with_text(params, cfg, jnp.asarray(x), jnp.asarray(cond),
                                jnp.asarray(text), jnp.asarray(time), mask=jnp.asarray(mask),
                                backend="sdpa")
    got = TU.forward_with_text(model, port_cfg(cfg), _t(x), _t(cond), _t(text), _t(time),
                               mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cfm_sample_matches_jax(small):
    """The Euler CFG sampler with the UNetT backbone and injected noise."""
    params, model = small
    rng = np.random.default_rng(7)
    b, n = 1, 24  # the fused CFG batch has the forward test's shapes
    cond = rng.standard_normal((b, n, SMALL.mel_dim)).astype(np.float32)
    lens = np.array([8], np.int32)
    cond[0, 8:] = 0.0
    text = rng.integers(0, SMALL.text_num_embeds, (b, 9)).astype(np.int32)
    text[0, 7:] = -1
    duration = np.array([21], np.int32)
    noise = rng.standard_normal((b, n, SMALL.mel_dim)).astype(np.float32)
    opts = JC.SampleOptions(steps=4)
    want = JC.sample(params, SMALL, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(duration),
                     jnp.asarray(noise), lens=jnp.asarray(lens), opts=opts, backend="sdpa")
    got = TC.sample(model, port_cfg(SMALL), _t(cond), _t(text), _t(duration), _t(noise),
                    lens=_t(lens), opts=TC.SampleOptions(steps=4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_state_from_jax_params_inverts_the_jax_loader(small):
    params, model = small
    state = TK.state_from_jax_params(jax.tree.map(np.asarray, params), SMALL, prefix="")
    own = model.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_load_reference_named_checkpoint(small, tmp_path, fmt):
    params, ref = small
    state = {"ema_model." + k: torch.from_numpy(v.copy()) for k, v in
             TK.state_from_jax_params(jax.tree.map(np.asarray, params), SMALL).items()}
    state["ema_model.step"] = torch.tensor(10)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(state, path)
    else:
        torch.save({"ema_model_state_dict": state}, path)
    model = TC.CFM(port_cfg(SMALL))
    TK.load_dit_state(model, TK.load_torch_state(path, use_ema=True))
    for k, v in ref.state_dict().items():
        assert torch.equal(model.transformer.state_dict()[k], v), k


def test_e2tts_yaml_loads_the_builtin_architecture():
    ycfg = TCLI.parse_simple_yaml(os.path.join(REPO, "configs", "E2TTS_Base.yaml"))
    cfg = from_yaml_dict(ycfg["model"])
    assert cfg.arch == MODEL_CONFIGS["E2TTS_Base"].arch and cfg.name == "E2TTS_Base"
    assert from_yaml_dict(to_yaml_dict(cfg)) == cfg
    mm = MODEL_CONFIGS["F5TTS_MMDiT_Base"]
    assert from_yaml_dict(to_yaml_dict(mm)) == mm


def test_trainer_takes_two_updates_of_a_tiny_unett(tmp_path):
    from f5_tts_tpu_torch.train import dataset as TD
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer

    arch = UNetTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_num_embeds=256,
                       text_dim=16, max_pos=512, pe_attn_head=1, text_mask_padding=False)
    rng = np.random.default_rng(5)
    rows = [{"mel_spec": rng.standard_normal((frames, 100)).astype(np.float32),
             "text": "hello world", "duration": frames * 256 / 24_000}
            for frames in (41, 47, 52, 58)]
    ds = TD.CustomDataset(rows, preprocessed_mel=True)
    tr = Trainer(ModelConfig(name="tiny_unett", arch=arch, tokenizer="byte"), None,
                 OptimConfig(num_warmup_updates=1, total_updates=4, learning_rate=1e-3),
                 ckpt_dir=str(tmp_path), batch_size_per_device=120, max_samples=2,
                 device="cpu", seed=3, log_every_updates=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TC.CFM(arch)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    model, _, update = tr.train(model, ds, epochs=1, resume=False)
    assert update == 2
    moved = [k for k, p in model.named_parameters() if not torch.equal(start[k], p.detach())]
    assert len(moved) == len(start)


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_engine_serves_the_other_backbones(backbone):
    """InferenceEngine with a tiny UNetT / MMDiT on the CPU: the serving qkv
    fusion where the backbone has one, and the sampler through the backbone
    dispatch give what ``cfm.sample`` gives on the unfused module with the
    engine's per-row noise."""
    from f5_tts_tpu_torch.infer import engine as TE
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MMDiTConfig

    if backbone == "UNetT":
        arch = dataclasses.replace(port_cfg(SMALL), mel_dim=100, text_num_embeds=64)
    else:
        arch = MMDiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2,
                           text_num_embeds=64, max_pos=64, text_max_pos=64)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = TC.CFM(arch)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(5))
    ref = TC.CFM(arch)
    ref.load_state_dict(model.state_dict())
    eng = TE.InferenceEngine(model, ModelConfig(name="tiny", arch=arch), buckets=(32, 64),
                             options=TE.EngineOptions(nfe_step=4))
    rng = np.random.default_rng(6)
    ref_mel = rng.standard_normal((9, 100)).astype(np.float32)
    text = rng.integers(0, 64, 11)
    mels, _, gen = eng.generate_batch([ref_mel], [text], [30], seeds=[3], decode=False)
    assert mels.shape == (1, 32, 100) and gen == [21]
    cond = torch.zeros((1, 32, 100))
    cond[0, :9] = torch.from_numpy(ref_mel)
    text_ids = torch.full((1, 32), -1, dtype=torch.int32)
    text_ids[0, :11] = torch.from_numpy(text)
    want = TC.sample(ref.transformer, arch, cond, text_ids, torch.tensor([30]),
                     TE.draw_noise([3], 32, 100, "cpu"), lens=torch.tensor([9], dtype=torch.int32),
                     opts=TC.SampleOptions(steps=4))
    np.testing.assert_allclose(mels, want.numpy(), atol=1e-5)
