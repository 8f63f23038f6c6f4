"""Port MMDiT (models/mmdit.py) against the JAX package with carried-over
weights: the forward with the joint-attention key mask off and on,
``forward_cfg``, the CFM sampler and loss (which hand MMDiT the text
stream's mask), the masked gradient on the training kernels' path, the
checkpoint loaders and the Trainer.

Both sides hold the same random weights for tests/test_mmdit.py's
``SMALL``: the port's seeded module init with its AdaLN gates, final norm
and ``proj_out`` randomized (zero gates would make the comparison vacuous),
read into the JAX parameter tree by the JAX package's own loader
``mmdit_params_from_state``; ``state_from_jax_params`` maps that tree back
exactly.  fp32 on the CPU; the port runs the plain versions of
its kernels.  Forward, sampler and loss: JAX ``backend="sdpa"``, atol 1e-4
(the same fp32 math summed in another order).  The masked gradient: both
sides on ``backend="flash_train"``, the JAX Pallas kernels in interpret
mode (which round to bf16 where the port's plain versions do not), with
tests/test_flash_attention.py's tolerances: loss rtol 1e-3, each gradient
leaf's mean error below 5e-2 of its mean magnitude.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models import mmdit as JM
from f5_tts_tpu.utils.ckpt import mmdit_params_from_state
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.models import mmdit as TM
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.configs import MMDiTConfig, ModelConfig
from f5_tts_tpu_torch.utils import ckpt as TK
from tests.test_mmdit import SMALL

ATOL = 1e-4


def port_cfg(cfg):
    names = {f.name for f in dataclasses.fields(MMDiTConfig)}
    return MMDiTConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def carried(cfg, seed=0):
    """(JAX params, port CFM) holding the same seeded random weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TC.CFM(port_cfg(cfg)).eval().requires_grad_(False)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(50 + seed))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return mmdit_params_from_state(state, cfg), model


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, b=2, n=24, nt=24, seed=17):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 5:] = -1
    time = np.array([0.4, 0.6], np.float32)
    mask = np.arange(n)[None, :] < np.array([[n], [17]])
    return x, cond, text, time, mask


@pytest.fixture(scope="module")
def small():
    return carried(SMALL)


@pytest.mark.parametrize("attn_mask_enabled", [False, True])
def test_forward_matches_jax(small, attn_mask_enabled):
    params, model = small
    x, cond, text, time, mask = _inputs(SMALL)
    want = JM.forward_with_text(params, SMALL, jnp.asarray(x), jnp.asarray(cond),
                                jnp.asarray(text), jnp.asarray(time), mask=jnp.asarray(mask),
                                backend="sdpa", attn_mask_enabled=attn_mask_enabled)
    got = TM.forward_with_text(model.transformer, port_cfg(SMALL), _t(x), _t(cond), _t(text),
                               _t(time), mask=_t(mask), attn_mask_enabled=attn_mask_enabled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forward_cfg_matches_jax(small):
    params, model = small
    # one row: the fused CFG batch then has the forward test's shapes, whose
    # JAX ops are compiled already
    x, cond, text, time, mask = (a[1:] for a in _inputs(SMALL, seed=3))
    te_c = JM.text_embedding(params, SMALL, jnp.asarray(text))
    te_u = JM.text_embedding(params, SMALL, jnp.asarray(text), drop_text=True)
    c_mask = text != -1
    want = JM.forward_cfg(params, SMALL, jnp.asarray(x), jnp.asarray(cond), te_c, te_u,
                          jnp.asarray(time), mask=jnp.asarray(mask), c_mask=jnp.asarray(c_mask),
                          backend="sdpa", attn_mask_enabled=True)
    pc, bb = port_cfg(SMALL), model.transformer
    got = TM.forward_cfg(bb, pc, _t(x), _t(cond), TM.text_embedding(bb, pc, _t(text)),
                         TM.text_embedding(bb, pc, _t(text), drop_text=True), _t(time),
                         mask=_t(mask), c_mask=_t(c_mask), attn_mask_enabled=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_cfm_sample_matches_jax(small):
    """The sampler hands MMDiT ``c_mask = text_ids != -1``; injected noise."""
    params, model = small
    rng = np.random.default_rng(7)
    b, n = 1, 24  # the fused CFG batch has the forward test's shapes
    cond = rng.standard_normal((b, n, SMALL.mel_dim)).astype(np.float32)
    text = np.full((b, n), -1, np.int32)  # padded to the bucket width, as the engine does
    text[0, :7] = rng.integers(0, SMALL.text_num_embeds, 7)
    duration, lens = np.array([21], np.int32), np.array([8], np.int32)
    noise = rng.standard_normal((b, n, SMALL.mel_dim)).astype(np.float32)
    want = JC.sample(params, SMALL, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(duration),
                     jnp.asarray(noise), lens=jnp.asarray(lens), opts=JC.SampleOptions(steps=3),
                     backend="sdpa")
    got = TC.sample(model.transformer, port_cfg(SMALL), _t(cond), _t(text), _t(duration),
                    _t(noise), lens=_t(lens), opts=TC.SampleOptions(steps=3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cfm_loss_and_gradients_match_jax():
    cfg = dataclasses.replace(SMALL, depth=2)
    params, model = carried(cfg, seed=1)
    model.requires_grad_(True)
    rng = np.random.default_rng(2)
    b, n = 2, 24
    mel = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, 10)).astype(np.int32)
    text[1, 6:] = -1
    lens = np.array([n, 15], np.int32)
    span = np.zeros((b, n), bool)
    span[0, 3:20], span[1, 2:12] = True, True
    inj = {"x0": rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32),
           "time": np.array([0.25, 0.7], np.float32), "span_mask": span}
    inj_j = dict({k: jnp.asarray(v) for k, v in inj.items()}, drop_audio=False, drop_both=False)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JC.loss(
        p, cfg, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens), jax.random.PRNGKey(0),
        backend="sdpa", inject=inj_j)))(params)
    inj_t = dict({k: _t(v) for k, v in inj.items()}, drop_audio=False, drop_both=False)
    loss_t = model(_t(mel), _t(text), _t(lens), inject=inj_t, backend="train_auto")
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = TK.state_from_jax_params(jax.tree.map(np.asarray, grads_j), cfg)
    for name, p in model.named_parameters():
        scale = max(np.abs(want[name]).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale, want[name] / scale, atol=1e-4,
                                   err_msg=name)


def test_masked_gradient_on_the_training_kernels_matches_jax():
    """Both sides on ``flash_train`` with the two-segment mask: JAX through
    its Pallas kernels in interpret mode, the port through kernels C, D, E's
    plain versions under the autograd Function."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = dataclasses.replace(SMALL, depth=2)
    params, model = carried(cfg, seed=2)
    model.requires_grad_(True)
    x, cond, text, time, mask = _inputs(cfg, n=24, nt=8, seed=9)  # joint length 32

    def jloss(p):
        o = JM.forward_with_text(p, cfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                 jnp.asarray(time), mask=jnp.asarray(mask),
                                 backend="flash_train", attn_mask_enabled=True)
        return ((o * jnp.asarray(mask)[:, :, None]) ** 2).mean()

    with pltpu.force_tpu_interpret_mode():
        loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    bb = model.transformer
    o = TM.forward_with_text(bb, port_cfg(cfg), _t(x), _t(cond), _t(text), _t(time),
                             mask=_t(mask), backend="flash_train", attn_mask_enabled=True)
    loss_t = ((o * _t(mask)[:, :, None]) ** 2).mean()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-3)
    want = TK.state_from_jax_params(jax.tree.map(np.asarray, grads_j), cfg, prefix="")
    for name, p in bb.named_parameters():
        err = np.abs(p.grad.numpy() - want[name]).mean() / (np.abs(want[name]).mean() + 1e-6)
        assert err < 5e-2, (name, err)


def test_state_from_jax_params_inverts_the_jax_loader(small, tmp_path):
    params, ref = small
    state = TK.state_from_jax_params(jax.tree.map(np.asarray, params), SMALL, prefix="")
    own = ref.transformer.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)
    # a bare (unprefixed) .pt state dict loads into the CFM's transformer
    path = str(tmp_path / "mmdit.pt")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in state.items()}, path)
    model = TC.CFM(port_cfg(SMALL))
    TK.load_dit_state(model, TK.load_torch_state(path))
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_zero_init_output_and_text_max_pos():
    cfg = port_cfg(SMALL)
    model = TM.MMDiT(cfg)
    x = torch.randn((1, 16, cfg.mel_dim))
    out = TM.forward_with_text(model, cfg, x, x, torch.zeros((1, 5), dtype=torch.int32),
                               torch.tensor([0.5]))
    assert torch.all(out == 0)  # AdaLN-zero gates and proj_out, as the reference
    long = torch.zeros((1, cfg.text_max_pos + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="text_max_pos"):
        TM.text_embedding(model, cfg, long)


def test_trainer_takes_two_updates_of_a_tiny_mmdit(tmp_path):
    from f5_tts_tpu_torch.train import dataset as TD
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer

    arch = MMDiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_num_embeds=256,
                       max_pos=512, text_max_pos=256)
    rng = np.random.default_rng(6)
    rows = [{"mel_spec": rng.standard_normal((frames, 100)).astype(np.float32),
             "text": "hello world", "duration": frames * 256 / 24_000}
            for frames in (41, 47, 52, 58)]
    ds = TD.CustomDataset(rows, preprocessed_mel=True)
    tr = Trainer(ModelConfig(name="tiny_mmdit", arch=arch, tokenizer="byte"), None,
                 OptimConfig(num_warmup_updates=1, total_updates=4, learning_rate=1e-3),
                 ckpt_dir=str(tmp_path), batch_size_per_device=120, max_samples=2,
                 device="cpu", seed=3, log_every_updates=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TC.CFM(arch)
    # with the AdaLN gates and proj_out at zero, the projections upstream of
    # proj_out get no gradient in the first updates
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(1))
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    model, _, update = tr.train(model, ds, epochs=1, resume=False)
    assert update == 2
    moved = [k for k, p in model.named_parameters() if not torch.equal(start[k], p.detach())]
    assert len(moved) == len(start)
