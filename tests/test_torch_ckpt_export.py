"""The port's checkpoint utilities against the JAX package's, on the CPU:
``.npz`` snapshots interchange both ways with JAX ``save_pytree`` /
``load_pytree`` (the three backbones, Vocos, BigVGAN), the exported
``.safetensors`` reads in JAX ``load_torch_state``, ``expand_text_embedding``
keeps JAX's rows; ``F5TTS``, ``train/cli.py`` and ``finetune_cli`` load the
snapshots; ``finetune_cli`` runs end to end; the six dataset preparation
scripts write what JAX's write.  Weights cross bitwise (fp32 numpy both
ways); the JAX trees are built by the JAX package's ``*_params_from_state``
from the port's seeded modules (no JAX ``init``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import bigvgan as JB
from f5_tts_tpu.models import configs as JC
from f5_tts_tpu.utils import ckpt as JK
from f5_tts_tpu_torch.models import bigvgan as TB
from f5_tts_tpu_torch.models.backbones import build_backbone
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, DiTConfig, MMDiTConfig, UNetTConfig
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.train import dataset as TD
from f5_tts_tpu_torch.utils import ckpt as TK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONES = {
    "dit": (DiTConfig(dim=64, depth=3, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                      text_num_embeds=30, text_dim=24, conv_layers=2, max_pos=128,
                      long_skip_connection=True, qk_norm="rms_norm"), JC.DiTConfig),
    "unett": (UNetTConfig(dim=64, depth=4, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                          text_num_embeds=30, text_dim=24, conv_layers=1, max_pos=128),
              JC.UNetTConfig),
    "mmdit": (MMDiTConfig(dim=64, depth=3, heads=4, dim_head=16, ff_mult=2, mel_dim=10,
                          text_num_embeds=30, max_pos=128, text_max_pos=64), JC.MMDiTConfig),
}
NARROW = dict(num_mels=100, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _seeded(make, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m = make()
    with torch.no_grad():  # every tensor non-zero, so no leaf can cross as zeros by accident
        g = torch.Generator().manual_seed(seed + 1)
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return m


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_cfg(cfg, jcls):
    names = {f.name for f in dataclasses.fields(jcls)}
    return jcls(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def _cases():
    """(name, port state, JAX tree of it, port npz -> state, port state -> tree)."""
    for name, (cfg, jcls) in BACKBONES.items():
        state = _np_state(_seeded(lambda cfg=cfg: build_backbone(cfg)))
        yield (name, state, JK.params_from_state(state, _jax_cfg(cfg, jcls)),
               lambda p, cfg=cfg: TK.backbone_state_from_npz(p, cfg),
               lambda s, cfg=cfg: TK.jax_params_from_state(s, cfg))
    state = _np_state(_seeded(Vocos))
    yield ("vocos", state, JK.vocos_params_from_state(state),
           lambda p: TK.vocos_state_from_jax_params(TK.load_pytree(p)),
           TK.vocos_jax_params_from_state)
    tcfg, jcfg = TB.BigVGANConfig(**NARROW), JB.BigVGANConfig(**NARROW)
    state = {k: v for k, v in _np_state(_seeded(lambda: TB.BigVGAN(tcfg))).items()
             if k.endswith(("weight", "bias", "alpha", "beta"))}
    yield ("bigvgan", state, JK.bigvgan_params_from_state(state, jcfg),
           lambda p: TB_state(p, tcfg), lambda s: TK.bigvgan_jax_params_from_state(s, tcfg))


def TB_state(path, cfg):
    return TK.bigvgan_state_from_jax_params(TK.load_pytree(path), cfg)


CASES = {c[0]: c for c in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_npz_snapshots_interchange_with_jax(name, tmp_path):
    _, state, jtree, load_port, to_tree = CASES[name]
    # the port writes, JAX reads into its own tree
    TK.save_pytree(to_tree(state), str(tmp_path / "port.npz"))
    got = JK.load_pytree(jtree, str(tmp_path / "port.npz"))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict((jax.tree_util.keystr(k), v)
                     for k, v in jax.tree_util.tree_leaves_with_path(jtree))
    assert len(flat_got) == len(flat_want)
    for k, v in flat_got:
        assert np.array_equal(np.asarray(v), np.asarray(flat_want[jax.tree_util.keystr(k)])), k
    # JAX writes, the port reads back its own state dict
    JK.save_pytree(jtree, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)  # one layout
    back = load_port(str(tmp_path / "jax.npz"))
    assert back.keys() == state.keys()
    for k in state:
        assert np.array_equal(np.asarray(back[k]), state[k]), k


def test_f5tts_and_the_train_cli_load_npz_snapshots(tmp_path, monkeypatch):
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.train import cli as TCLI

    cfg = MODEL_CONFIGS["F5TTS_Tiny"]
    cfm = _seeded(lambda: CFM(cfg.arch), 3)
    voc = _seeded(Vocos, 4)
    TK.save_pytree(TK.jax_params_from_state(cfm.state_dict(), cfg.arch), str(tmp_path / "m.npz"))
    TK.save_pytree(TK.vocos_jax_params_from_state(voc.state_dict()), str(tmp_path / "v.npz"))
    tts = F5TTS(model="F5TTS_Tiny", ckpt_file=str(tmp_path / "m.npz"),
                vocoder_local_path=str(tmp_path / "v.npz"), device="cpu")
    for want, got in ((cfm.state_dict(), tts.engine.model.state_dict()),
                      (voc.state_dict(), tts.engine.vocoder.state_dict())):
        assert all(torch.equal(want[k], got[k].float()) for k in want)
    st = TCLI.load_pretrained(str(tmp_path / "m.npz"), cfg.arch)
    assert all(torch.equal(torch.as_tensor(st[k]), v)
               for k, v in cfm.transformer.state_dict().items())


def test_export_safetensors_reads_in_jax_and_back(tmp_path):
    from safetensors.torch import save_file

    cfg = MODEL_CONFIGS["F5TTS_Tiny"]
    cfm = _seeded(lambda: CFM(cfg.arch), 5)
    path = str(tmp_path / "release.safetensors")
    TK.export_safetensors(cfm.state_dict(), path)
    want = {k: v.numpy() for k, v in cfm.state_dict().items()}
    got = JK.load_torch_state(path)  # JAX: strips ema_model., keeps transformer.*
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    JK.dit_params_from_state(got, _jax_cfg(cfg.arch, JC.DiTConfig))
    back = TK.load_torch_state(path)
    assert all(torch.equal(back[k], v) for k, v in cfm.state_dict().items())
    # the reader against a file the safetensors package wrote, every dtype
    tensors = {"a": torch.randn(3, 5), "b": torch.randn(7).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.tensor([True]),
               "e": torch.zeros(0)}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    read = TK.read_safetensors(str(tmp_path / "lib.safetensors"))
    assert all(read[k].dtype == v.dtype and torch.equal(read[k], v) for k, v in tensors.items())
    TK.write_safetensors(tensors, str(tmp_path / "own.safetensors"))
    from safetensors.torch import load_file

    lib = load_file(str(tmp_path / "own.safetensors"))
    assert all(torch.equal(lib[k], v) for k, v in tensors.items())
    half = TK.params_astype(cfm.state_dict(), torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())


def test_expand_text_embedding_keeps_the_jax_rows():
    cfg = DiTConfig(dim=32, depth=1, heads=2, dim_head=16, mel_dim=10, text_num_embeds=20,
                    text_dim=8, conv_layers=0)
    state = _np_state(_seeded(lambda: CFM(cfg), 6))
    jtree = JK.dit_params_from_state(state, _jax_cfg(cfg, JC.DiTConfig))
    want = np.asarray(JK.expand_text_embedding(jtree, 27)["text_embed"]["embed"]["weight"])
    got = TK.expand_text_embedding({k: torch.from_numpy(v) for k, v in state.items()}, 27)
    emb = got["transformer.text_embed.text_embed.weight"].numpy()
    assert emb.shape == want.shape == (28, 8)
    assert np.array_equal(emb[:21], want[:21])
    assert 0.005 < emb[21:].std() < 0.05  # new rows ~ N(0, 0.02)
    same = TK.expand_text_embedding(got, 10)  # never shrinks
    assert same["transformer.text_embed.text_embed.weight"].shape[0] == 28


def test_finetune_cli_end_to_end(tmp_path, monkeypatch):
    """A custom vocabulary larger than the pretrained table, the pretrained
    file snapshotted into the run directory and never rotated, the final
    EMA weights exported."""
    from f5_tts_tpu_torch.text.tokenizer import load_vocab
    from f5_tts_tpu_torch.train import finetune_cli

    monkeypatch.chdir(tmp_path)
    base = MODEL_CONFIGS["F5TTS_Tiny"]
    vocab_path = tmp_path / "vocab.txt"
    bundled = load_vocab(None)
    vocab_path.write_text("".join(f"{t}\n" for t in list(bundled) + ["x1", "x2", "x3"]))
    pre_arch = dataclasses.replace(base.arch, text_num_embeds=len(bundled))
    pre = _seeded(lambda: CFM(pre_arch), 7)
    torch.save({"ema_model_state_dict": {f"ema_model.{k}": v
                                         for k, v in pre.state_dict().items()}},
               tmp_path / "pre.pt")
    rng = np.random.default_rng(8)
    rows = [{"mel_spec": rng.standard_normal((int(n), 100)).astype(np.float32), "text": "ni hao",
             "duration": int(n) * 256 / 24_000} for n in rng.integers(40, 90, 6)]
    monkeypatch.setattr(TD, "load_dataset",
                        lambda *a, **k: TD.CustomDataset(rows, preprocessed_mel=True))
    update = finetune_cli.main([
        "--exp_name", "F5TTS_Tiny", "--dataset_name", "speak", "--pretrain", str(tmp_path / "pre.pt"),
        "--tokenizer", "custom", "--tokenizer_path", str(vocab_path), "--device", "cpu",
        "--epochs", "1", "--batch_size_per_gpu", "300", "--num_warmup_updates", "1",
        "--save_per_updates", "1", "--keep_last_n_checkpoints", "0",
        "--export_safetensors", str(tmp_path / "out.safetensors")])
    run = tmp_path / "ckpts" / "speak"
    assert update >= 2
    assert sorted(os.listdir(run)) == ["model_last.pt", "pretrained_pre.pt", "train_log.jsonl"]
    exported = TK.load_torch_state(str(tmp_path / "out.safetensors"))
    last = torch.load(run / "model_last.pt", weights_only=True)["ema_model_state_dict"]
    assert all(torch.equal(v, last[f"ema_model.{k}"]) for k, v in exported.items())
    emb = exported["transformer.text_embed.text_embed.weight"]
    assert emb.shape[0] == len(bundled) + 3 + 1  # grown to the custom vocabulary
    old = pre.state_dict()["transformer.text_embed.text_embed.weight"]
    assert (emb[:len(old)] - old).abs().max() < 1e-2  # the pretrained rows, a few steps on


# ------------------------------------------------------- dataset preparation

def _wav(path, secs, seed):
    from f5_tts_tpu_torch.audio.io import save_wav

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    save_wav(str(path), (0.1 * rng.standard_normal(int(secs * 16_000))).astype(np.float32), 16_000)


def _make_inputs(kind, root):
    texts = ["你好，世界!", "Hello world.", "再见?", "speech"]
    if kind == "csv_wavs":
        lines = ["audio_file|text"]
        for i, t in enumerate(texts):
            _wav(root / f"w{i}.wav", 0.5 + 0.3 * i, i)
            lines.append(f"w{i}.wav|{t}")
        lines.append("missing.wav|gone")
        (root / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
        return [str(root / "metadata.csv")]
    if kind == "emilia":
        for lang in ("ZH", "EN"):
            os.makedirs(root / lang, exist_ok=True)
            recs = [{"wav": f"{lang}/a{i}.mp3", "text": t, "duration": d, "dnsmos": m}
                    for i, (t, d, m) in enumerate(zip(texts, (1.0, 0.1, 5.0, 2.0),
                                                      (3.5, 3.5, 2.0, 3.1)))]
            recs.append({"wav": "x.mp3", "text": "ああああああああああああああ", "duration": 2.0})
            (root / lang / "m.jsonl").write_text(
                "\n".join(json.dumps(r, ensure_ascii=False) for r in recs) + "\nnot json\n",
                encoding="utf-8")
        return [str(root)]
    if kind == "emilia_v2":
        for i, t in enumerate(texts):
            meta = root / "EN" / f"s{i % 2}" / f"u{i}.json"
            os.makedirs(meta.parent, exist_ok=True)
            meta.write_text(json.dumps({"text": t, "duration": 1.0 + i, "dnsmos": 3.3}),
                            encoding="utf-8")
            if i != 2:
                _wav(meta.with_suffix(".wav"), 0.4, i)
        return [str(root)]
    if kind == "libritts":
        for i, t in enumerate(texts):
            wav = root / "train-clean-100" / "19" / "198" / f"19_198_{i}.wav"
            _wav(wav, 0.2 + 0.5 * i, i)
            wav.with_name(wav.stem + ".normalized.txt").write_text(t, encoding="utf-8")
        return [str(root)]
    if kind == "ljspeech":
        lines = []
        for i, t in enumerate(texts):
            _wav(root / "wavs" / f"LJ{i}.wav", 0.5 + 0.2 * i, i)
            lines.append(f"LJ{i}|raw {t}|{t}")
        lines.append("LJ9|short")
        (root / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
        return [str(root)]
    for i, t in enumerate(texts):  # wenetspeech4tts
        wav = root / "Premium" / f"d{i % 2}" / f"x{i}.wav"
        _wav(wav, 0.6 + 0.2 * i, i)
        wav.with_suffix(".txt").write_text(t + "\n2.5", encoding="utf-8")
    return [str(root)]


def _written(out):
    from datasets import Dataset

    rows = Dataset.from_file(os.path.join(out, "raw.arrow")).to_list()
    return (rows, json.load(open(os.path.join(out, "duration.json"))),
            open(os.path.join(out, "vocab.txt"), encoding="utf-8").read())


@pytest.mark.parametrize("kind", ["csv_wavs", "emilia", "emilia_v2", "libritts", "ljspeech",
                                  "wenetspeech4tts"])
def test_prepare_scripts_write_what_jax_writes(kind, tmp_path):
    import importlib

    mod_t = importlib.import_module(f"f5_tts_tpu_torch.train.datasets.prepare_{kind}")
    mod_j = importlib.import_module(f"f5_tts_tpu.train.datasets.prepare_{kind}")
    args = _make_inputs(kind, tmp_path / "in")
    outs = []
    for mod, tag in ((mod_t, "t"), (mod_j, "j")):
        out = str(tmp_path / f"out_{tag}")
        mod.prepare(*args, out)
        outs.append(_written(out))
    assert outs[0] == outs[1]
    assert outs[0][0], f"{kind}: no rows written"
