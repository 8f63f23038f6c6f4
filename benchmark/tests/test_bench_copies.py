"""The frozen copies of the FLOP and roofline arithmetic, held to hand counts."""

from types import SimpleNamespace

import pytest

from benchmark import flops, roofline


def dit(**kw):
    base = dict(dim=8, text_dim=4, conv_layers=1, conv_mult=2, mel_dim=2, heads=2, dim_head=4,
                depth=1, ff_mult=2, backbone="DiT")
    return SimpleNamespace(**{**base, **kw})


def test_dit_forward_flops_hand_count():
    a, n = dit(), 3
    text = n * (7 * 4 + 2 * 2 * 4 * 4 * 2)  # dwconv + two pointwise convs
    embed = n * 2 * (2 * 2 + 4) * 8 + 2 * n * (31 * 8 / 16 * 8) * 2
    block = n * 2 * 8 * 8 * 4 + 2 * 2 * n * n * 8 + n * 2 * 8 * 16 * 2 + 2 * 8 * 6 * 8
    out = n * 2 * 8 * 2
    assert flops.dit_forward_flops(a, n) == pytest.approx(text + embed + block + out)


def test_unett_forward_flops_hand_count():
    a = SimpleNamespace(dim=8, text_dim=None, mel_dim=2, heads=2, dim_head=4, depth=2, ff_mult=4,
                        skip_connect_type="concat", backbone="UNetT")
    n, m = 3, 4  # the time token joins the sequence
    embed = n * 2 * (2 * 2 + 2) * 8
    block = m * 2 * 8 * 8 * 4 + 2 * 2 * m * m * 8 + m * 2 * 8 * 32 * 2
    skip = m * 2 * 16 * 8
    assert flops.unett_forward_flops(a, n) == pytest.approx(embed + 2 * block + skip + n * 2 * 8 * 2)


def test_sampling_and_train_counts():
    a = dit()
    model = SimpleNamespace(arch=a)
    fwd, text = flops.dit_forward_flops(a, 5), flops.dit_text_embed_flops(a, 5)
    want = 4 * 2 * fwd - 3 * 2 * text + flops.vocos_forward_flops(5)
    assert flops.sampling_flops(model, 4, 5) == pytest.approx(want)
    assert flops.train_step_flops(model, 5, batch=2) == pytest.approx(6 * fwd)


def test_attention_bounds_hand_count():
    # one row of 2 heads, n 4, dh 8, 3 valid keys: 4 * 2 * 4 * 3 * 8 operations
    ops = 4 * 2 * 4 * 3 * 8
    nbytes = 4 * 1 * 2 * 4 * 8 * 2 + 4
    assert roofline.attention_fwd(1, 2, 4, 8, [3]) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    t = roofline.train_attention(1, 2, 4, 8, [3])
    t16, t32 = 2 * 4 * 8 * 2.0, 2 * 4 * 4.0
    assert t.C == pytest.approx(max(ops / 989e12, (4 * t16 + t32 + 4) / 3.35e12))
    assert t.D == pytest.approx(max(1.5 * ops / 989e12, (5 * t16 + 2 * t32 + 4) / 3.35e12))
    assert t.E == pytest.approx(max(2 * ops / 989e12, (6 * t16 + 2 * t32 + 4) / 3.35e12))


def test_convpos_bound_hand_count():
    ops = 2 * 2 * 31 * 64 * 128 * (10 + 7)
    nbytes = 2 * 2 * 16 * 128 * 2 + 2 * (128 * 64 * 31 + 128) * 2 + 8
    assert roofline.convpos(2, 16, 128, [10, 7]) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))


def test_bounds_at_full_width_are_bound_by_operations():
    assert roofline.attention_fwd(16, 16, 2048, 64, [2000] * 16) == pytest.approx(
        16 * 4 * 16 * 2048 * 2000 * 64 / 989e12)
