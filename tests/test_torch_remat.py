"""Activation checkpointing in the port (models/remat.py): every remat
policy gives the gradients of the run without it, bitwise, for the three
backbones (MMDiT with its two-segment attention mask), and launches kernel
C's function as the policy says: once per block per micro-step under
``flash`` and ``dots_flash`` (o and L kept), twice under ``nothing`` and
``dots`` (recomputed).  ``dots`` keeps every linear's product.  The
port's gradients without remat are held against JAX elsewhere
(tests/test_torch_flash_train.py, test_torch_train_step.py).
``resolve_remat_policy`` follows JAX's rule, each side with its own
``auto`` threshold.  All on the CPU, where C is its plain version.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from f5_tts_tpu.models import dit as JDIT
from f5_tts_tpu.models.configs import DiTConfig as JDiTConfig
from f5_tts_tpu.models.configs import ModelConfig as JModelConfig
from f5_tts_tpu.train import trainer as JT
from f5_tts_tpu_torch.models import mmdit, remat
from f5_tts_tpu_torch.models.backbones import build_backbone, randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig, MMDiTConfig, UNetTConfig
from f5_tts_tpu_torch.ops import flash_attention as FA

# tests/test_dit.py, test_unett.py and test_mmdit.py SMALL
ARCHS = {
    "dit": DiTConfig(dim=64, depth=3, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                     text_num_embeds=30, text_dim=24, conv_layers=2, max_pos=128),
    "unett": UNetTConfig(dim=64, depth=4, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                         text_num_embeds=30, text_dim=24, conv_layers=1, max_pos=128,
                         text_mask_padding=False, pe_attn_head=1),
    "mmdit": MMDiTConfig(dim=64, depth=3, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                         text_num_embeds=30, max_pos=128, text_max_pos=64),
}
POLICIES = ("nothing", "dots", "flash", "dots_flash", "auto")
B, N, NT = 2, 24, 9


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _inputs(arch):
    g = torch.Generator().manual_seed(5)
    d = arch.mel_dim
    mel = torch.randn(B, N, d, generator=g)
    ids = torch.randint(0, arch.text_num_embeds, (B, NT), generator=g)
    ids[1, 6:] = -1
    lens = torch.tensor([N, N - 7])
    inj = {"x0": torch.randn(B, N, d, generator=g), "time": torch.tensor([0.3, 0.8]),
           "span_mask": torch.rand(B, N, generator=g) > 0.3, "drop_audio": False,
           "drop_both": False}
    return mel, ids, lens, inj


def _run(name, policy, mixed_precision=False):
    """(loss, gradients, C calls, op counts) of one loss + backward."""
    arch = ARCHS[name]
    if policy is not None:
        arch = dataclasses.replace(arch, checkpoint_activations=True, remat_policy=policy)
    torch.manual_seed(0)
    model = CFM(arch) if name != "mmdit" else build_backbone(arch)
    randomize_zero_init(model.transformer if name != "mmdit" else model,
                        torch.Generator().manual_seed(1))
    mel, ids, lens, inj = _inputs(arch)
    params = dict(model.named_parameters())
    if mixed_precision:
        params_in = {k: p.to(torch.bfloat16) for k, p in params.items()}
        mel = mel.to(torch.bfloat16)
    else:
        params_in = params

    def loss_fn():
        if name != "mmdit":
            return torch.func.functional_call(model, params_in, (mel, ids, lens), {"inject": inj})
        # MMDiT's masked joint attention: the two-segment training kernels
        mask = torch.arange(N)[None] < lens[:, None]
        out = mmdit.forward_with_text(model, arch, mel, mel * 0.5, ids, inj["time"], mask=mask,
                                      backend="train_auto", attn_mask_enabled=True)
        return (out.float().square() * mask[..., None]).mean()

    calls = {"n": 0}
    plain = FA.flash_attention_fwd_stats_plain

    def counted(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    FA.flash_attention_fwd_stats_plain = counted
    try:
        with _OpCount() as ops:
            loss = loss_fn()
            grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        FA.flash_attention_fwd_stats_plain = plain
    return loss.detach(), grads, calls["n"], ops.ops


_BASE = {}


def _baseline(name):
    if name not in _BASE:
        _BASE[name] = _run(name, None)
    return _BASE[name]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_every_policy_gives_the_gradients_without_remat(name, policy):
    loss0, grads0, calls0, _ = _baseline(name)
    loss, grads, calls, _ = _run(name, policy)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    depth = ARCHS[name].depth
    assert calls0 == depth  # one C per block without remat
    # auto resolves to dots_flash at B x N tokens (far below the threshold)
    recomputes_c = policy in ("nothing", "dots")
    assert calls == (2 if recomputes_c else 1) * depth


@pytest.mark.parametrize("name", ["dit", "mmdit"])
def test_dots_keeps_every_linear_and_nothing_recomputes_them(name):
    linear = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    count = {pol: sum(_run(name, pol)[3][op] for op in linear)
             for pol in ("nothing", "dots", "dots_flash")}
    base = sum(_baseline(name)[3][op] for op in linear)
    assert count["dots"] == count["dots_flash"] == base < count["nothing"]


def test_remat_reads_the_weights_the_forward_read_under_mixed_precision():
    """The trainer swaps bf16 copies in with ``functional_call``; the
    recompute runs after that call returned and still reads them."""
    loss0, grads0, _, _ = _run("dit", None, mixed_precision=True)
    for policy in ("nothing", "flash"):
        loss, grads, calls, _ = _run("dit", policy, mixed_precision=True)
        assert torch.equal(loss, loss0)
        assert all(g.dtype == torch.float32 for g in grads)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_region_draws_no_random_numbers():
    """The checkpoint does not stash the RNG state: the loss draws before
    the backbone, so the generator advances the same with or without remat."""
    arch = dataclasses.replace(ARCHS["dit"], checkpoint_activations=True, remat_policy="nothing")
    outs = []
    for a in (ARCHS["dit"], arch):
        torch.manual_seed(0)
        model = CFM(a)
        mel, ids, lens, _ = _inputs(a)
        gen = torch.Generator().manual_seed(9)
        loss = model(mel, ids, lens, generator=gen, drop_generator=torch.Generator().manual_seed(9))
        torch.autograd.grad(loss, list(model.parameters()))
        outs.append((loss.detach(), torch.rand(3, generator=gen)))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("policy", ["auto", "flash", "nothing"])
@pytest.mark.parametrize("batch_type", ["frame", "sample"])
def test_resolve_remat_policy_follows_jax_with_each_threshold(policy, batch_type, offset):
    jarch = dataclasses.replace(JDiTConfig(), checkpoint_activations=True, remat_policy=policy)
    tarch = dataclasses.replace(DiTConfig(), checkpoint_activations=True, remat_policy=policy)
    jgot = JT.resolve_remat_policy(JModelConfig(name="t", arch=jarch),
                                   JDIT.AUTO_DOTS_FLASH_MAX_TOKENS + offset, batch_type)
    tgot = remat.resolve_remat_policy(ModelConfig(name="t", arch=tarch),
                                      remat.AUTO_DOTS_FLASH_MAX_TOKENS + offset, batch_type)
    assert tgot.arch.remat_policy == jgot.arch.remat_policy
    off = dataclasses.replace(tarch, checkpoint_activations=False)
    assert remat.resolve_remat_policy(ModelConfig(name="t", arch=off), 1, batch_type).arch == off
    assert remat.resolve("auto", remat.AUTO_DOTS_FLASH_MAX_TOKENS) == "dots_flash"
    with pytest.raises(ValueError, match="token count"):
        remat.resolve("auto", None)
