"""The narrow model configurations: the shape gates in front of kernels A
(and C, D, E, F) and B, and the 768-dim Small backbones against JAX.

The gates are ``ops/attention.attention_takes_kernel`` (used by
``attention`` and MMDiT's joint attention) and ``models/layers.py``
``conv_pos_takes_kernel`` (used by ``conv_pos_embed``), pure functions of
the device type and static shapes.  Held here: on ``"cuda"`` they pick the
kernel exactly where the kernel's own predicate takes the shape, which
includes every attention and ConvPositionEmbedding shape of the four Base
configurations; they agree with JAX's shape rules, restated here because
JAX's ``flash_supported`` and ``conv_pos_supported`` return False on the
CPU, everywhere but the two named widths (dh 128, 128-channel groups),
which JAX would run on its kernels and the port runs plain; on ``"cpu"``
they keep the kernels' functions, whose CPU implementation is the plain
version; the forced ``"flash"`` and ``"flash_train"`` always pick the
kernel.

F5TTS_v1_Small (``forward_cfg``) and E2TTS_Small (``forward``) at depth 2
then match JAX on the CPU in fp32 within 1e-4 relative, once on the CPU's
route and once with the gates answering as on the card (the narrow
ConvPositionEmbedding through ``conv_pos_plain``).  Weights: the port's
seeded init with the zero-initialized projections filled, carried into JAX
by its ``params_from_state``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.models import unett as JU
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models import dit as TD
from f5_tts_tpu_torch.models import layers as TL
from f5_tts_tpu_torch.models import mmdit as TM
from f5_tts_tpu_torch.models import unett as TU
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.ops import attention as TA
from f5_tts_tpu_torch.ops import flash_attention as FA
from f5_tts_tpu_torch.ops import fused_convpos as FC

REL_TOL = 1e-4
HEAD_DIMS = (16, 32, 48, 64, 128)
# (d, groups): 4-, 8-, 48-, 64- and 128-channel groups
CONV_SHAPES = ((64, 16), (128, 16), (768, 16), (1024, 16), (2048, 16))
AUTO = ("auto", "train_auto")
FORCED = ("flash", "flash_train")
BASE = ("F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base", "F5TTS_MMDiT_Base")
# where JAX's shape rules admit a width the port's kernels were not built for
DEPARTURES_DH = {128}
DEPARTURES_CONV = {(2048, 16)}


def jax_flash_shape_rule(dh: int) -> bool:
    """``flash_supported`` / ``flash_seg_supported``'s head rule (JAX
    ``ops/flash_attention.py:528-540``) without its platform and length
    parts."""
    return dh % 64 == 0


def jax_conv_pos_shape_rule(d: int, groups: int) -> bool:
    """``conv_pos_supported``'s group rule (JAX ``ops/fused_convpos.py:153-165``)
    without its platform and length parts."""
    return groups % 2 == 0 and d % groups == 0 and (d // groups) % 64 == 0


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("backend", AUTO + FORCED)
def test_attention_gate_on_the_card(dh, backend):
    got = TA.attention_takes_kernel("cuda", backend, dh)
    if backend in FORCED:
        assert got  # forced: the kernel, which raises for a width it lacks
    else:
        assert got == FA.kernel_takes(dh) == (dh == FA.HEAD_DIM)
        if dh not in DEPARTURES_DH:
            assert got == jax_flash_shape_rule(dh)
        else:
            assert jax_flash_shape_rule(dh) and not got


@pytest.mark.parametrize("d,groups", CONV_SHAPES)
def test_conv_pos_gate_on_the_card(d, groups):
    got = TL.conv_pos_takes_kernel("cuda", d, groups)
    assert got == FC.kernel_takes(d, groups) == (d == groups * FC.GROUP_WIDTH)
    if (d, groups) not in DEPARTURES_CONV:
        assert got == jax_conv_pos_shape_rule(d, groups)
    else:
        assert jax_conv_pos_shape_rule(d, groups) and not got


@pytest.mark.parametrize("backend", AUTO + FORCED)
def test_cpu_keeps_its_route(backend):
    for dh in HEAD_DIMS:
        assert TA.attention_takes_kernel("cpu", backend, dh)
    for d, groups in CONV_SHAPES:
        assert TL.conv_pos_takes_kernel("cpu", d, groups)


@pytest.mark.parametrize("name", BASE)
def test_every_base_shape_takes_the_kernels(name):
    arch = MODEL_CONFIGS[name].arch
    small = dataclasses.replace(arch, depth=2)
    model = CFM(small).transformer
    convs = [(m.conv1d[0].in_channels, m.groups) for m in model.modules()
             if isinstance(m, TL.ConvPositionEmbedding)]
    assert convs, name
    for d, groups in convs:
        assert TL.conv_pos_takes_kernel("cuda", d, groups), (name, d, groups)
    for backend in AUTO:
        assert TA.attention_takes_kernel("cuda", backend, arch.dim_head), name


@pytest.mark.parametrize("name,attn,conv", [
    ("F5TTS_v1_Small", True, False), ("F5TTS_Small", True, False),
    ("E2TTS_Small", True, False), ("F5TTS_Tiny", True, False)])
def test_narrow_configurations_route(name, attn, conv):
    """The Small configurations keep kernel A (dh 64) and run the plain
    ConvPositionEmbedding (48-channel groups); F5TTS_Tiny likewise (dh 64,
    4-channel groups)."""
    arch = MODEL_CONFIGS[name].arch
    assert TA.attention_takes_kernel("cuda", "auto", arch.dim_head) is attn
    assert TL.conv_pos_takes_kernel("cuda", arch.dim, 16) is conv


def test_wrappers_still_raise_for_narrow_shapes():
    x = torch.zeros(1, 8, 768)
    w = torch.zeros(768, 48, 31)
    b = torch.zeros(768)
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="64-channel groups"):
        FC.conv_pos_cuda(x, w, b, w, b, lens, 16)
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head dim 64"):
        FA.flash_attention_cuda(q, q, q, torch.tensor([8], dtype=torch.int32))


def test_freeze_taps_makes_no_copies_for_a_plain_width(monkeypatch):
    cpe = TL.ConvPositionEmbedding(768)
    cpe.freeze_taps()  # the CPU route keeps conv_pos_fused, which takes taps
    assert cpe.taps is not None
    monkeypatch.setattr(TL, "conv_pos_takes_kernel", lambda dev, d, g: False)
    cpe.freeze_taps()
    assert cpe.taps is None


@pytest.fixture
def card_route(monkeypatch):
    """The gates answer as on the card for the CPU tensors of a test; every
    call that would launch a kernel runs the kernel's plain version."""
    attn, conv = TA.attention_takes_kernel, TL.conv_pos_takes_kernel
    monkeypatch.setattr(TA, "attention_takes_kernel", lambda dev, be, dh: attn("cuda", be, dh))
    monkeypatch.setattr(TM, "attention_takes_kernel", lambda dev, be, dh: attn("cuda", be, dh))
    monkeypatch.setattr(TL, "conv_pos_takes_kernel", lambda dev, d, g: conv("cuda", d, g))
    plain = []
    real = TL.conv_pos_plain
    monkeypatch.setattr(TL, "conv_pos_plain", lambda *a: plain.append(1) or real(*a))
    return plain


def _carried(name, depth=2, seed=0):
    arch = dataclasses.replace(MODEL_CONFIGS[name].arch, depth=depth)
    jarch = dataclasses.replace(JAX_CONFIGS[name].arch, depth=depth)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CFM(arch).eval().requires_grad_(False)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(seed + 1))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return arch, jarch, params_from_state(state, jarch), model.transformer


def _inputs(arch, b=2, n=40, nt=14, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, arch.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, arch.mel_dim)).astype(np.float32)
    text = rng.integers(0, arch.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 9:] = -1
    time = np.array([0.25, 0.6], np.float32)
    lens = np.array([n, n - 11], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    return x, cond, text, time, lens, mask


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def v1_small():
    return _carried("F5TTS_v1_Small")


@pytest.fixture(scope="module")
def e2_small():
    return _carried("E2TTS_Small")


@pytest.mark.parametrize("route", ["cpu", "card"])
def test_f5tts_v1_small_forward_cfg_matches_jax(v1_small, route, request):
    plain = request.getfixturevalue("card_route") if route == "card" else None
    arch, jarch, params, model = v1_small
    x, cond, text, time, lens, mask = _inputs(arch)
    n = x.shape[1]
    te_c = JD.text_embedding(params, jarch, jnp.asarray(text), n, lens=jnp.asarray(lens))
    te_u = JD.text_embedding(params, jarch, jnp.asarray(text), n, lens=jnp.asarray(lens),
                             drop_text=True)
    want = JD.forward_cfg(params, jarch, jnp.asarray(x), jnp.asarray(cond), te_c, te_u,
                          jnp.asarray(time), mask=jnp.asarray(mask), backend="sdpa")
    tc = TD.text_embedding(model, arch, _t(text), n, lens=_t(lens))
    tu = TD.text_embedding(model, arch, _t(text), n, lens=_t(lens), drop_text=True)
    got = TD.forward_cfg(model, arch, _t(x), _t(cond), tc, tu, _t(time), mask=_t(mask),
                         backend="auto")
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL_TOL
    if plain is not None:
        assert len(plain) == 1  # one ConvPositionEmbedding, the plain composition


@pytest.mark.parametrize("route", ["cpu", "card"])
def test_e2tts_small_forward_matches_jax(e2_small, route, request):
    plain = request.getfixturevalue("card_route") if route == "card" else None
    arch, jarch, params, model = e2_small
    x, cond, text, time, lens, mask = _inputs(arch)
    n = x.shape[1]
    te = JU.text_embedding(params, jarch, jnp.asarray(text), n)
    want = JU.forward(params, jarch, jnp.asarray(x), jnp.asarray(cond), te, jnp.asarray(time),
                      mask=jnp.asarray(mask), backend="sdpa")
    tte = TU.text_embedding(model, arch, _t(text), n)
    got = TU.forward(model, arch, _t(x), _t(cond), tte, _t(time), mask=_t(mask), backend="auto")
    assert _rel(got.numpy(), want) <= REL_TOL
    if plain is not None:
        assert len(plain) == 1


def test_narrow_mmdit_joint_attention_takes_sdpa_on_the_card(card_route, monkeypatch):
    """A dh-32 MMDiT on the card's route: the masked joint attention runs
    ``sdpa`` on the concatenated mask, not the two-segment kernel, and gives
    what ``backend="sdpa"`` gives."""
    arch = dataclasses.replace(MODEL_CONFIGS["F5TTS_MMDiT_Base"].arch, dim=64, depth=2, heads=2,
                               dim_head=32, text_num_embeds=40)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = CFM(arch).eval().requires_grad_(False)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(4))
    x, cond, text, time, _, mask = _inputs(arch, n=24, nt=10)
    text = np.minimum(text, 39)
    args = (_t(x), _t(cond), _t(text), _t(time))

    def refuse(*a, **k):
        raise AssertionError("the two-segment kernel's function was called")

    monkeypatch.setattr(TM, "flash_attention_two_segment", refuse)
    got = TM.forward_with_text(model.transformer, arch, *args, mask=_t(mask),
                               attn_mask_enabled=True, backend="auto")
    want = TM.forward_with_text(model.transformer, arch, *args, mask=_t(mask),
                                attn_mask_enabled=True, backend="sdpa")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
