"""The plain reference against the port at a tiny size on the CPU, in fp32,
on the same seeded weights; the seeded weights themselves."""

import numpy as np
import pytest
import torch

from benchmark import program, run, traffic, weights
from benchmark.reference import model as R
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def cfgs(tiny_root):
    b = run.Bench(tiny_root)
    return {c["name"]: b.config(c["name"]) for c in b.spec["configs"]}


@pytest.mark.parametrize("name", ["f5tts_v1_base", "e2tts_base"])
def test_reference_tensors_are_the_programs_and_none_is_zero(cfgs, name):
    cfg = cfgs[name]
    _, model = program.build_model(cfg, 5, "cpu")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == {k: tuple(v) for k, v in R.backbone_shapes(cfg).items()}
    voc = program.build_vocoder(cfg, 5, "cpu")
    assert {k: tuple(p.shape) for k, p in voc.named_parameters()} == R.vocos_shapes(cfg["vocoder"])
    for mod in (model, voc):
        for k, p in mod.named_parameters():
            assert p.abs().min() > 0 or p.ne(0).float().mean() > 0.99, k
    zero_init = [n for n, _ in model.named_parameters()
                 if "attn_norm.linear" in n or "norm_out.linear" in n or "proj_out" in n]
    for n in zero_init:
        assert dict(model.named_parameters())[n].abs().mean() > 0, n
    W = weights.draw(R.backbone_shapes(cfg), program.seeds(5)[0], "cpu")
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), W[k]), k


def test_the_full_size_tables_match_the_port():
    b = run.Bench()
    for c in b.spec["configs"]:
        cfg = b.config(c["name"])
        from f5_tts_tpu_torch.models.cfm import CFM
        with torch.device("meta"):
            model = CFM(program.model_config(cfg).arch)
        got = {k: tuple(p.shape) for k, p in model.named_parameters()}
        assert got == {k: tuple(v) for k, v in R.backbone_shapes(cfg).items()}
        assert abs(sum(np.prod(s) for s in got.values()) - cfg["params"]) / cfg["params"] < 0.01


@pytest.mark.parametrize("name", ["f5tts_v1_base", "e2tts_base"])
def test_backbone_forward_matches_the_port(cfgs, name):
    from f5_tts_tpu_torch.models.backbones import get_backbone

    cfg = cfgs[name]
    mcfg, model = program.build_model(cfg, 9, "cpu")
    W = weights.draw(R.backbone_shapes(cfg), program.seeds(9)[0], "cpu")
    g = torch.Generator().manual_seed(0)
    b, n = 2, 40
    x, cond = torch.randn(b, n, 100, generator=g), torch.randn(b, n, 100, generator=g)
    ids = torch.randint(0, 2545, (b, 12), generator=g)
    ids[1, 9:] = -1
    lens = torch.tensor([40, 31])
    mask = torch.arange(n)[None] < lens[:, None]
    t = torch.tensor([0.3, 0.8])
    bb = get_backbone(mcfg.arch)
    with torch.no_grad():
        te = bb.text_embedding(model.transformer, mcfg.arch, ids, n, lens=lens)
        want = bb.forward(model.transformer, mcfg.arch, x, cond, te, t, mask=mask, backend="sdpa")
        te_r = R.text_embed(W, cfg, ids, n, lens, False, R.FP32)
        got = R.backbone(cfg)(W, cfg["arch"], x, cond, te_r, t, mask, R.FP32)
    assert torch.allclose(te_r, te, atol=1e-5)
    keep = mask[..., None]
    assert torch.allclose(got * keep, want * keep, rtol=1e-4, atol=1e-4)


def test_vocos_and_mel_match_the_port(cfgs):
    from f5_tts_tpu_torch.models import vocos
    from f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_np

    cfg = cfgs["f5tts_v1_base"]
    voc = program.build_vocoder(cfg, 3, "cpu")
    V = weights.draw(R.vocos_shapes(cfg["vocoder"]), program.seeds(3)[1], "cpu")
    mel = torch.randn(1, 30, 100, generator=torch.Generator().manual_seed(1)) - 3
    want = vocos.decode(voc, mel, lens=torch.tensor([30]))
    assert torch.allclose(R.vocos(V, mel), want, atol=1e-5)
    wav = traffic.audio_bank(1, clips=1, seconds=2.0)[0, :30_000].astype(np.float32) / 32767
    want = log_mel_np(wav, MelConfig())[0]
    got = R.log_mel(torch.from_numpy(wav)[None])[0].numpy()
    assert np.allclose(got, want, atol=1e-3)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    w = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    opt = torch.optim.AdamW(list(ref.values()), lr=1e-3, weight_decay=0.01)
    mine = R.AdamW(w, 1e-3, warmup=0, total=10**9, max_norm=1e9)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in w.items()}
        for k, p in ref.items():
            p.grad = grads[k].clone()
        opt.step()
        mine.step(grads)
    for k in w:
        assert torch.allclose(w[k], ref[k].detach(), atol=1e-6)


def test_a_resumed_schedule_matches_the_programs():
    from f5_tts_tpu_torch.train.step import make_optimizer

    cfg = run.Bench().config("f5tts_v1_base")
    g = torch.Generator().manual_seed(1)
    w = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    w0 = w["a"].clone()
    params = [torch.nn.Parameter(v.clone()) for v in w.values()]
    opt_cfg = program.optim_config(cfg, 40_000, mixed_precision=False)
    prog = make_optimizer(params, opt_cfg)
    program.resume_schedule(prog, opt_cfg, 20_007)
    o = cfg["optim"]
    mine = R.AdamW(w, o["learning_rate"], o["num_warmup_updates"], 40_000, o["max_grad_norm"],
                   start=20_007)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in w.items()}
        prog.step([grads[k].clone() for k in w])
        mine.step(grads)
    for k, p in zip(w, params):
        assert torch.allclose(w[k], p.detach(), atol=1e-7)
    assert (w["a"] - w0).abs().mean() > 5e-5  # moved at the resumed rate, not the warm-up's


def test_the_ema_rule_matches_the_programs():
    from f5_tts_tpu_torch.train.step import OptimConfig, ema_update

    c = OptimConfig(ema_decay=0.9, ema_update_after_step=20, ema_update_every=10)
    g = torch.Generator().manual_seed(2)
    E = {"a": torch.randn(6, generator=g)}
    e = [E["a"].clone()]
    for update in range(1, 41):
        W = {"a": torch.randn(6, generator=g)}
        ema_update(e, [W["a"]], update, c)
        R.ema_update(E, W, update, 0.9, 20, 10)
        assert torch.allclose(E["a"], e[0], atol=1e-7), update


def test_the_tiny_copy_is_small():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        root = tiny.make(d)
        cfg = run.Bench(root).config("f5tts_v1_base")
        assert cfg["arch"]["dim"] == 64
