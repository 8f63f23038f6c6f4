"""The port's Gradio logic, the Gradio shells and the finetune toolkit
(``infer/gradio_logic.py``, ``infer/gradio_app.py``,
``train/finetune_gradio.py``) against the JAX package's, on the same inputs:
every logic function gives JAX's output; without ``gradio`` both apps
raise as JAX's do; ``Slicer`` cuts the same chunks bitwise;
``calculate_train``, the settings files, ``vocab_check`` and
``expand_vocab`` equal JAX's; ``transcribe_all`` writes JAX's segments
and metadata; ``prune_checkpoint`` reads the port trainer's ``.pt``, the
reference's ``.safetensors`` and a ``.npz`` snapshot, and refuses an orbax
directory; ``infer_test`` serves a pruned checkpoint."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import json
import os

import numpy as np
import pytest
import torch

from f5_tts_tpu.infer import gradio_logic as JL
from f5_tts_tpu.train import finetune_gradio as JFG
from f5_tts_tpu_torch.infer import gradio_logic as TL
from f5_tts_tpu_torch.train import finetune_gradio as TFG

TEXTS = [
    "{Regular} Hello there. {Angry} Why me?! {Whisper} go away",
    "no marker at all",
    json.dumps({"name": "Speaker1_Happy", "seed": 42, "speed": 0.8}) + " Hi! {Sad} bye",
    "{Shouting} FIRST\nSECOND {Calm} third",
    "",
    "{Angry}",
    '{"name": "Broken", "seed": x} text {Regular} more',
]


@pytest.mark.parametrize("text", TEXTS)
def test_speech_type_parsing_equals_jax(text):
    assert TL.parse_speechtypes_text(text) == JL.parse_speechtypes_text(text)
    for names in (("Regular",), ("Regular", "Angry", "Whisper"), ("", "")):
        assert TL.missing_speech_types(text, *names) == JL.missing_speech_types(text, *names)


def test_logic_functions_equal_jax(tmp_path):
    rows = (["Regular", "", "Sad", "X"], ["a.wav", "", "c.wav", None], ["ra", "", "rc", ""])
    assert TL.collect_speech_types(*rows) == JL.collect_speech_types(*rows)
    for seed, rnd in ((123, False), (0, False), (TL.MAX_SEED, False), (-1, False),
                      (2**31, False), (5, True)):
        assert TL.normalize_seed(seed, rnd, np.random.RandomState(7)) == \
            JL.normalize_seed(seed, rnd, np.random.RandomState(7))
    txt = tmp_path / "gen.txt"
    txt.write_text("  some text to speak \n", encoding="utf-8")
    for path in (str(txt), None, ""):
        assert TL.load_text_from_file(path) == JL.load_text_from_file(path)
    p = str(tmp_path / "last_used.txt")
    TL.save_last_used_custom("/ckpt.pt", "/vocab.txt", '{"dim": 1024}', p)
    assert JL.load_last_used_custom(p) == TL.load_last_used_custom(p) == \
        ("/ckpt.pt", "/vocab.txt", '{"dim": 1024}')
    short = tmp_path / "short.txt"
    short.write_text("/only_ckpt.pt\n")
    for path in (str(short), str(tmp_path / "missing.txt")):
        assert TL.load_last_used_custom(path) == JL.load_last_used_custom(path)
    for name in ("MAX_SEED", "DEFAULT_CUSTOM_MODEL_CFG", "DEFAULT_CHAT_SYSTEM_PROMPT"):
        assert getattr(TL, name) == getattr(JL, name)
    assert TL.default_cache_path() == JL.default_cache_path()
    conv = []
    for mod in (TL, JL):
        conv_m = mod.conversation_add_user([], "  ")
        conv_m = mod.conversation_add_user(conv_m, "hi")
        conv.append(conv_m)
    assert conv[0] == conv[1] == [{"role": "user", "content": "hi"}]
    for c in ([], conv[0], conv[0] + [{"role": "assistant", "content": "hello!"}],
              conv[0] + [{"role": "assistant", "content": [{"type": "text", "text": "b"}]}],
              conv[0] + [{"role": "assistant", "content": []}]):
        assert TL.last_assistant_reply(c) == JL.last_assistant_reply(c)


def test_infer_cache_equals_jax():
    logs = []
    for mod in (TL, JL):
        cache, calls = mod.InferCache(maxsize=2), []
        got = [cache.get_or_compute((k,), lambda v=v: calls.append(v) or v)
               for k, v in (("a", 1), ("a", 99), ("b", 2), ("c", 3), ("a", 4), ("c", 5))]
        logs.append((got, calls, cache.hits, cache.misses, list(cache._store)))
    assert logs[0] == logs[1]


def test_apps_without_gradio_raise_as_jax(monkeypatch):
    import sys

    from f5_tts_tpu.infer import gradio_app as JAPP
    from f5_tts_tpu_torch.infer import gradio_app as TAPP

    monkeypatch.setitem(sys.modules, "gradio", None)  # absent, whatever is installed
    for build in (TAPP.build_app, JAPP.build_app):
        with pytest.raises(RuntimeError, match="gradio is not installed"):
            build()
    for build in (TFG.build_app, JFG.build_app):
        with pytest.raises(RuntimeError, match="gradio is not installed"):
            build()
    assert (TAPP.MODEL_ALIASES, TAPP.DEFAULT_TTS_MODEL, TAPP.MAX_SPEECH_TYPES) == \
        (JAPP.MODEL_ALIASES, JAPP.DEFAULT_TTS_MODEL, JAPP.MAX_SPEECH_TYPES)


def _takes(sr=24000):
    rng = np.random.default_rng(5)
    speech = rng.standard_normal(int(2.5 * sr)).astype(np.float32) * 0.2
    quiet = rng.standard_normal(sr).astype(np.float32) * 1e-4
    return [np.concatenate([speech, quiet, speech[::-1], quiet[: sr // 5], speech[: sr]]),
            np.zeros(3 * sr, np.float32), speech, np.stack([speech, speech[::-1]])]


@pytest.mark.parametrize("kw", [{}, {"threshold": -30.0, "min_length": 1000,
                                     "min_interval": 200, "max_sil_kept": 500}])
def test_slicer_chunks_are_bitwise_jax(kw):
    for wav in _takes():
        got, want = TFG.Slicer(24000, **kw).slice(wav), JFG.Slicer(24000, **kw).slice(wav)
        assert len(got) == len(want) >= 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        TFG.Slicer(24000, min_length=100, min_interval=300)


def test_calculate_train_settings_and_vocab_equal_jax(tmp_path, monkeypatch):
    for hours in (0.1, 0.5, 3.0, 20.0, 500.0):
        assert TFG.calculate_train(hours) == JFG.calculate_train(hours)
    assert TFG.DEFAULT_SETTINGS == JFG.DEFAULT_SETTINGS
    monkeypatch.chdir(tmp_path)
    TFG.save_settings("proj_pinyin", {"learning_rate": 3e-5, "epochs": 7})
    assert JFG.load_settings("proj_pinyin") == TFG.load_settings("proj_pinyin")
    JFG.save_settings("other_char", {"batch_size_per_device": 800})
    assert TFG.load_settings("other_char")["batch_size_per_device"] == 800
    assert TFG.load_settings("nope_pinyin") == JFG.load_settings("nope_pinyin")
    assert TFG.create_data_project("myvoice") == JFG.create_data_project("myvoice")
    assert TFG.get_list_projects() == JFG.get_list_projects() == ["myvoice_pinyin"]

    meta = tmp_path / "metadata.csv"
    meta.write_text("audio_file|text\nwavs/a.wav|hello wörld ñ\nwavs/b.wav|你好 ☃ ok\n",
                    encoding="utf-8-sig")
    assert TFG.vocab_check(str(meta)) == JFG.vocab_check(str(meta))
    assert TFG.vocab_count("hello world") == JFG.vocab_count("hello world")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("a\nb\nc\n", encoding="utf-8")
    out = []
    for mod, name in ((TFG, "port.txt"), (JFG, "jax.txt")):
        n = mod.expand_vocab(str(vocab), ["c", "☃", "ñ"], str(tmp_path / name))
        out.append((n, (tmp_path / name).read_text(encoding="utf-8")))
    assert out[0] == out[1]
    assert TFG.vocab_check(str(meta), str(tmp_path / "port.txt")) == \
        JFG.vocab_check(str(meta), str(tmp_path / "jax.txt"))


def _tiny_cfm(seed):
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    return _seeded(lambda: CFM(MODEL_CONFIGS["F5TTS_Tiny"].arch), seed)


def test_prune_checkpoint_reads_port_and_reference_files(tmp_path):
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.utils import ckpt as CK

    raw, ema = _tiny_cfm(0), _tiny_cfm(1)
    pt = str(tmp_path / "model_100.pt")  # the port trainer's checkpoint layout
    CK.save_train_checkpoint(pt, raw, ema, {"state": {}, "param_groups": []}, {}, 100, 100)
    want = {k: v for k, v in ema.state_dict().items() if k.startswith("transformer.")}
    outs = {}
    for tag, mod in (("port", TFG), ("jax", JFG)):
        out = str(tmp_path / f"{tag}.safetensors")
        assert "pruned" in mod.prune_checkpoint(pt, out, save_ema=True)
        outs[tag] = CK.load_torch_state(out)
    assert outs["port"].keys() == outs["jax"].keys()
    for k, v in outs["port"].items():
        assert torch.equal(v, outs["jax"][k])
    for k, v in want.items():
        assert torch.equal(outs["port"][k], v)
    # the online weights, into a .pt; then the pruned release file itself
    online = str(tmp_path / "online.pt")
    TFG.prune_checkpoint(pt, online, save_ema=False, safetensors=False)
    got = CK.load_torch_state(online, use_ema=False)
    assert torch.equal(got["transformer.proj_out.weight"],
                       raw.state_dict()["transformer.proj_out.weight"])
    again = str(tmp_path / "again.safetensors")
    TFG.prune_checkpoint(str(tmp_path / "port.safetensors"), again)
    assert all(torch.equal(CK.load_torch_state(again)[k], v) for k, v in want.items())
    # a JAX-layout .npz backbone snapshot
    arch = MODEL_CONFIGS["F5TTS_Tiny"].arch
    npz = str(tmp_path / "ema.npz")
    CK.save_pytree(CK.jax_params_from_state(ema.state_dict(), arch), npz)
    from_npz = str(tmp_path / "npz.safetensors")
    TFG.prune_checkpoint(npz, from_npz, exp_name="F5TTS_Tiny")
    got = CK.load_torch_state(from_npz)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v)
    # expanded embeddings: JAX's numpy draw, in both packages
    sizes = [mod.expand_model_embeddings(again, str(tmp_path / f"x_{i}.safetensors"), 5)
             for i, mod in enumerate((TFG, JFG))]
    assert sizes[0] == sizes[1] == want["transformer.text_embed.text_embed.weight"].shape[0] + 5
    a, b = (CK.load_torch_state(str(tmp_path / f"x_{i}.safetensors")) for i in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_prune_checkpoint_refuses_an_orbax_directory(tmp_path):
    d = tmp_path / "model_100"
    d.mkdir()
    with pytest.raises(ValueError, match=r"only the JAX package reads.*\.npz"):
        TFG.prune_checkpoint(str(d), str(tmp_path / "out.safetensors"))


def test_monitor_log_tail_and_training_launch(tmp_path, monkeypatch):
    stats = TFG.get_combined_stats()
    assert "CPU" in stats and "RAM" in stats
    assert TFG.get_device_stats() == ([] if not torch.cuda.is_available() else
                                      TFG.get_device_stats())
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpts/voice", exist_ok=True)
    with open("ckpts/voice/train_log.jsonl", "w") as f:
        for i in range(30):
            f.write(json.dumps({"update": i, "loss": 1.0 / (i + 1)}) + "\n")
    assert TFG.tail_train_log("voice_pinyin", 5) == JFG.tail_train_log("voice_pinyin", 5)
    assert TFG.tail_train_log("missing_pinyin") == "(no training log yet)"
    assert "no training process" in TFG.stop_training()
    seen = {}
    monkeypatch.setattr(TFG, "launch_finetune",
                        lambda argv: seen.setdefault("argv", argv) and None)
    monkeypatch.setattr(TFG, "_train_process", type("P", (), {"pid": 1})())
    TFG.start_training("voice_pinyin", {"epochs": 3})
    want = {}
    monkeypatch.setattr(JFG, "launch_finetune", lambda argv: want.setdefault("argv", argv))
    monkeypatch.setattr(JFG, "_train_process", type("P", (), {"pid": 1})())
    JFG.start_training("voice_pinyin", {"epochs": 3})
    assert seen["argv"] == want["argv"] and "--epochs" in seen["argv"]


def test_transcribe_all_and_sampling_equal_jax(tmp_path, monkeypatch):
    """Both toolkits slice and transcribe one audio folder (a fake ASR) into
    the same segments and ``metadata.csv``; the random sample is the same."""
    from f5_tts_tpu_torch.audio.io import save_wav

    sr = 24000
    raw = tmp_path / "raw"
    raw.mkdir()
    takes = _takes(sr)
    save_wav(str(raw / "take1.wav"), takes[0], sr)
    save_wav(str(raw / "take2.wav"), takes[2], 16000)  # resampled to 24 kHz
    monkeypatch.chdir(tmp_path)
    got = {}
    for tag, mod in (("port", TFG), ("jax", JFG)):
        proj = mod.create_data_project(f"voice_{tag}")
        n = []
        summary = mod.transcribe_all(proj, str(raw), transcribe_fn=lambda seg, s: n.append(
            len(seg)) or f"segment {len(n)} of {len(seg) / s:.3f} s.")
        data = tmp_path / "data" / proj
        wavs = {p.name: p.read_bytes() for p in sorted((data / "wavs").iterdir())}
        got[tag] = (summary.replace(proj, "P"), (data / "metadata.csv").read_text("utf-8-sig"),
                    wavs, mod.get_random_sample_transcribe(proj, seed=3)[0])
    assert got["port"] == got["jax"] and len(got["port"][2]) >= 2


def test_infer_test_on_a_project_checkpoint(tmp_path):
    """``infer_test`` serves a pruned checkpoint on the device asked for."""
    from f5_tts_tpu_torch.audio.io import load_wav
    from f5_tts_tpu_torch.utils import ckpt as CK

    ckpt = str(tmp_path / "pruned.safetensors")
    CK.export_safetensors(_tiny_cfm(2).state_dict(), ckpt)
    ref = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "assets", "basic_ref_en.wav")
    out = str(tmp_path / "test.wav")
    wav, sr = TFG.infer_test(ckpt, ref, "Some call me nature.", "a short test.",
                             exp_name="F5TTS_Tiny", nfe_step=2, seed=1, out_path=out,
                             random_vocoder=True, device="cpu")
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert load_wav(out)[1] == 24000
