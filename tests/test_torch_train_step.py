"""The port's training step (models/cfm.py loss, train/step.py) against the
JAX package.

``cfm.loss`` and its gradients: the port (plain attention and convpos
versions under their autograd Functions, ``backend="train_auto"``) against
JAX ``cfm.loss(backend="sdpa")`` with the same injected draws and
carried-over weights, in fp32; the JAX gradient tree is carried over with
``state_from_jax_params`` and compared per tensor at atol 1e-4 relative to
that tensor's largest value (fp32 sums in another order through a few
layers, and fp32 sin / cos of the 1000 t timestep angles).  The optimizer
is fed identical gradients on both sides and held to optax at rtol 1e-5
(fp32 AdamW arithmetic in another order); the schedule at rtol 1e-5 (optax
computes it in fp32, the port in Python floats).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.train import step as JS
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.train import step as TS
from f5_tts_tpu_torch.utils import ckpt as TK
from tests.test_dit import SMALL, make_params
from tests.test_torch_dit import port_cfg

TINY = dataclasses.replace(SMALL, depth=2, conv_layers=1)


def _batch(cfg, b=2, n=48, nt=14, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 9:] = -1
    lens = np.array([n, n - 13], np.int32)
    x0 = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    span = np.zeros((b, n), bool)
    span[0, 5:40] = True
    span[1, 2:30] = True
    return mel, text, lens, {"x0": x0, "time": np.array([0.25, 0.7], np.float32), "span_mask": span}


def _port_model(params, cfg):
    model = TC.CFM(port_cfg(cfg))
    TK.load_into(model, TK.state_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return model


@pytest.mark.parametrize("drops", [(False, False), (True, False), (False, True)],
                         ids=["no_drop", "drop_audio", "drop_both"])
def test_cfm_loss_and_gradients_match_jax(drops):
    cfg = TINY
    params = make_params(cfg, seed=3)
    mel, text, lens, inj = _batch(cfg)
    inj_j = {k: jnp.asarray(v) for k, v in inj.items()}
    inj_j.update(drop_audio=drops[0], drop_both=drops[1])
    loss_j, grads_j = jax.value_and_grad(lambda p: JC.loss(
        p, cfg, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens), jax.random.PRNGKey(0),
        backend="sdpa", inject=inj_j))(params)

    model = _port_model(params, cfg)
    inj_t = {k: torch.from_numpy(v) for k, v in inj.items()}
    inj_t.update(drop_audio=drops[0], drop_both=drops[1])
    loss_t = model(torch.from_numpy(mel), torch.from_numpy(text), torch.from_numpy(lens),
                   inject=inj_t, backend="train_auto")
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = TK.state_from_jax_params(jax.tree.map(np.asarray, grads_j), cfg)
    for name, p in model.named_parameters():
        w = want[name]
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("drop_audio,drop_text", [(False, False), (True, True)])
def test_forward_with_text_matches_jax(drop_audio, drop_text):
    from f5_tts_tpu.models import dit as JDiT
    from f5_tts_tpu_torch.models import dit as TDiT

    cfg = TINY
    params = make_params(cfg, seed=6)
    mel, text, lens, inj = _batch(cfg, seed=2)
    mask = np.arange(mel.shape[1])[None, :] < lens[:, None]
    want = JDiT.forward_with_text(
        params, cfg, jnp.asarray(inj["x0"]), jnp.asarray(mel), jnp.asarray(text),
        jnp.asarray(inj["time"]), mask=jnp.asarray(mask), lens=jnp.asarray(lens),
        drop_audio_cond=drop_audio, drop_text=drop_text, backend="sdpa")
    model = _port_model(params, cfg).transformer
    got = TDiT.forward_with_text(
        model, port_cfg(cfg), torch.from_numpy(inj["x0"]), torch.from_numpy(mel),
        torch.from_numpy(text), torch.from_numpy(inj["time"]), mask=torch.from_numpy(mask),
        lens=torch.from_numpy(lens), drop_audio_cond=drop_audio, drop_text=drop_text,
        backend="train_auto")
    np.testing.assert_allclose(got.detach().numpy() * mask[..., None],
                               np.asarray(want) * mask[..., None], atol=1e-4)


def test_mask_from_frac_lengths_bounds():
    """One contiguous span of floor(frac * len) frames, frac in [0.7, 1),
    inside [0, len)."""
    lens = torch.tensor([100, 37, 1, 64])
    pos = torch.arange(128)[None, :]
    for seed in range(20):
        m = TC.mask_from_frac_lengths(lens, 128, torch.Generator().manual_seed(seed))
        span = m.sum(dim=1)
        assert torch.all(span <= lens) and torch.all(span >= torch.floor(0.7 * lens))
        assert not torch.any(m & (pos >= lens[:, None]))
        rises = (m[:, 1:] & ~m[:, :-1]).sum(dim=1) + m[:, 0].long()
        assert torch.all(rises == (span > 0).long())


@pytest.mark.parametrize("cfg", [
    JS.OptimConfig(learning_rate=1e-3, num_warmup_updates=3, total_updates=10),
    JS.OptimConfig(learning_rate=2e-4, num_warmup_updates=0, total_updates=7),
    JS.OptimConfig(learning_rate=5e-5, num_warmup_updates=100),
], ids=["warm3", "warm0", "open_horizon"])
def test_lr_schedule_matches_optax(cfg):
    want = JS.lr_schedule(cfg)
    got = TS.lr_schedule(TS.OptimConfig(**dataclasses.asdict(cfg)))
    for count in (0, 1, 2, 3, 4, 6, 9, 10, 12, 50, 150):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, atol=1e-12)


def _opt_cases():
    base = dict(learning_rate=1e-2, num_warmup_updates=2, total_updates=10)
    return [JS.OptimConfig(max_grad_norm=100.0, **base),
            JS.OptimConfig(max_grad_norm=0.5, **base),
            JS.OptimConfig(max_grad_norm=0.5, grad_accumulation_steps=2, **base)]


@pytest.mark.parametrize("cfg", _opt_cases(), ids=["unclipped", "clipped", "accum2_clipped"])
def test_optimizer_updates_match_optax(cfg):
    """Identical gradients into make_optimizer (clip + AdamW [+ MultiSteps])
    and into the port's Optimizer; parameters after every micro-step."""
    rng = np.random.default_rng(9)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = JS.make_optimizer(cfg)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("a", "b")]
    opt = TS.make_optimizer(pt, TS.OptimConfig(**dataclasses.asdict(cfg)))
    clipped = 0
    for _ in range(3 * cfg.grad_accumulation_steps):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        clipped += float(optax.global_norm(g)) > cfg.max_grad_norm
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        for k, p in zip(("a", "b"), pt):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), rtol=1e-5,
                                       atol=1e-7)
    assert (clipped > 0) == (cfg.max_grad_norm < 1.0)


def test_adafactor_is_not_ported():
    """Adafactor is ported (tests/test_torch_train_rest.py); an optimizer
    that neither package has raises."""
    with pytest.raises(ValueError, match="adafactor"):
        TS.make_optimizer([torch.nn.Parameter(torch.zeros(2))],
                          TS.OptimConfig(optimizer="lion"))


def test_ema_update_matches_jax_under_accumulation():
    """k = 2: the EMA moves only on update micro-steps, indexed by updates."""
    cfg = JS.OptimConfig(ema_decay=0.9, ema_update_after_step=1, ema_update_every=2,
                         grad_accumulation_steps=2)
    tcfg = TS.OptimConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(4)
    e0 = rng.standard_normal((6,)).astype(np.float32)
    ej, et = jnp.asarray(e0), [torch.from_numpy(e0.copy())]
    k = cfg.grad_accumulation_steps
    for micro in range(1, 13):
        p = rng.standard_normal((6,)).astype(np.float32)
        did = micro % k == 0
        ej = JS.ema_update(ej, jnp.asarray(p), micro // k, cfg, enabled=did)
        before = et[0].clone()
        TS.ema_update(et, [torch.from_numpy(p)], micro // k, tcfg, enabled=did)
        np.testing.assert_allclose(et[0].numpy(), np.asarray(ej), rtol=1e-6)
        if not did:
            assert torch.equal(et[0], before)


def _tiny_step_setup(mixed: bool, k: int = 1):
    cfg = TINY
    model = _port_model(make_params(cfg, seed=5), cfg)
    ema = TC.CFM(port_cfg(cfg))
    ema.load_state_dict(model.state_dict())
    ocfg = TS.OptimConfig(mixed_precision=mixed, num_warmup_updates=1, total_updates=5,
                          learning_rate=1e-3, grad_accumulation_steps=k,
                          ema_update_after_step=0, ema_update_every=1)
    mel, text, lens, _ = _batch(cfg)
    batch = {"mel": torch.from_numpy(mel), "text_ids": torch.from_numpy(text),
             "lens": torch.from_numpy(lens)}
    return model, ema, TS.make_optimizer(list(model.parameters()), ocfg), ocfg, batch


def test_mixed_precision_gives_fp32_gradients_on_fp32_masters():
    model, ema, opt, ocfg, batch = _tiny_step_setup(mixed=True, k=2)
    micro, metrics = TS.train_step(model, opt, ema, 0, batch, seed=1, opt_cfg=ocfg)
    assert micro == 1 and metrics["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert torch.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0
    # the bf16 loss tracks the fp32 one on the same draws
    _, _, _, ocfg32, _ = _tiny_step_setup(mixed=False)
    m32, ema32, opt32, _, _ = _tiny_step_setup(mixed=False, k=2)
    _, met32 = TS.train_step(m32, opt32, ema32, 0, batch, seed=1, opt_cfg=ocfg32)
    np.testing.assert_allclose(metrics["loss"].item(), met32["loss"].item(), rtol=3e-2)


def test_train_step_updates_every_k_and_ema_follows():
    model, ema, opt, ocfg, batch = _tiny_step_setup(mixed=False, k=2)
    w0 = model.transformer.proj_out.weight.detach().clone()
    e0 = ema.transformer.proj_out.weight.detach().clone()
    micro = 0
    for _ in range(4):
        micro, _ = TS.train_step(model, opt, ema, micro, batch, seed=micro, opt_cfg=ocfg)
        w = model.transformer.proj_out.weight
        e = ema.transformer.proj_out.weight
        if micro % 2:  # accumulation micro-step: nothing moves
            assert torch.equal(w, w0) and torch.equal(e, e0)
        else:  # an update (lr 0 at update 0), then the EMA copies (update_after_step 0)
            assert micro == 2 or not torch.equal(w, w0)
            torch.testing.assert_close(e, w.detach() * (1 - 0.9999) + e0 * 0.9999)
            w0, e0 = w.detach().clone(), e.detach().clone()
