"""The port's command-line entry points and socket streaming on the CPU,
against the JAX package's (``tests/test_cli.py``): the inference CLI's
flags and defaults, its TOML handling end to end on the bundled examples,
the speech-edit CLI, and a socket server / client round trip, all on
F5TTS_Tiny with random weights at NFE 2 (``--device cpu``)."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import argparse
import os
import socket
import threading

import numpy as np
import pytest

from f5_tts_tpu.infer import cli as JCLI
from f5_tts_tpu_torch.audio.io import load_wav, save_wav
from f5_tts_tpu_torch.infer import cli as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "F5TTS_Tiny", "--init_random", "--nfe_step", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def ref_wav_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aud") / "ref.wav")
    sr = 24000
    t = np.arange(int(sr * 1.2)) / sr
    wav = (0.2 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    save_wav(path, wav.astype(np.float32), sr)
    return path


def _actions(parser: argparse.ArgumentParser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.choices, a.nargs, a.const,
             a.required, type(a).__name__) for a in parser._actions]


def test_parser_flags_and_defaults_equal_jax():
    assert _actions(C.build_parser()) == _actions(JCLI.build_parser())
    assert C.build_parser().prog == JCLI.build_parser().prog


@pytest.mark.parametrize("toml_name", ["basic.toml", "multi_voice.toml"])
def test_bundled_example_tomls_run(toml_name, tmp_path, monkeypatch):
    """The shipped examples run with the tiny random model: asset paths
    resolve relative to the TOML from any working directory (the
    multi-voice prompts are FLAC, through the native decoder)."""
    monkeypatch.chdir(tmp_path)
    out = C.main(["-c", os.path.join(REPO, "examples", toml_name), *TINY,
                  "--output_dir", str(tmp_path), "--output_file", "o.wav"])
    assert out == os.path.join(str(tmp_path), "o.wav") and os.path.isfile(out)
    wav, sr = load_wav(out)
    assert sr == 24000 and len(wav) > 1000 and np.isfinite(wav).all()


def test_cli_toml_voices_and_flags(ref_wav_path, tmp_path, monkeypatch):
    """A TOML with a second voice table; the sampler flags (explicit zeros
    included) reach the engine and override the TOML."""
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(f'''
model = "F5TTS_Tiny"
init_random = true
device = "cpu"
ref_audio = "{ref_wav_path}"
ref_text = "a simple tone reference."
gen_text = "[main] config driven. [alt] with another voice."
output_dir = "{tmp_path}"
output_file = "toml_out.wav"
nfe_step = 2
cfg_strength = 3.0

[voices.alt]
ref_audio = "{ref_wav_path}"
ref_text = "a simple tone reference."
''')
    seen = []
    real = C.P.infer_process

    def spy(engine, *a, **k):
        seen.append((engine.options.nfe_step, engine.options.cfg_strength,
                     engine.options.sway_sampling_coef))
        return real(engine, *a, **k)

    monkeypatch.setattr(C.P, "infer_process", spy)
    out = C.main(["-c", str(cfg), "--cfg_strength", "1.5", "--sway_sampling_coef", "0.0"])
    assert os.path.isfile(out) and out.endswith("toml_out.wav")
    assert seen == [(2, 1.5, 0.0)] * 2  # one call per voice segment


def test_cli_model_cfg_yaml_and_chunk_names(ref_wav_path, tmp_path):
    """--model_cfg loads a custom arch YAML; --save_chunk names files
    '{i}_{text}.wav', transliterated to ASCII by default."""
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(
        "model:\n  name: TinyCustom\n  backbone: DiT\n  tokenizer: pinyin\n"
        "  arch:\n    dim: 64\n    depth: 2\n    heads: 4\n    dim_head: 16\n"
        "    ff_mult: 2\n    text_dim: 24\n    text_num_embeds: 200\n"
        "    conv_layers: 1\n    mel_dim: 100\n")
    out = C.main(["--model_cfg", str(yaml_path), "--init_random", "--device", "cpu",
                  "--ref_audio", ref_wav_path, "--ref_text", "a simple tone reference.",
                  "--gen_text", "chunk naming check, voilà.", "--output_dir", str(tmp_path),
                  "--output_file", "mc.wav", "--nfe_step", "2", "--save_chunk"])
    assert os.path.isfile(out)
    names = sorted(os.listdir(tmp_path / "mc_chunks"))
    assert names and names[0].startswith("0_") and names[0].endswith(".wav")
    assert "voila" in names[0] and "voilà" not in names[0]


def test_speech_edit_cli(ref_wav_path, tmp_path):
    from f5_tts_tpu_torch.infer import speech_edit_cli

    out = str(tmp_path / "edit.wav")
    speech_edit_cli.main(["--model", "F5TTS_Tiny", "--init_random", "--device", "cpu",
                          "--nfe_step", "2", "--audio", ref_wav_path,
                          "--original_text", "a simple tone reference.",
                          "--target_text", "a simple tune reference.",
                          "--edit", "0.3,0.6", "--fix_duration", "0.5", "--seed", "1",
                          "--output", out])
    wav, sr = load_wav(out)
    # 1.2 s of source with 0.3 s re-timed to 0.5 s: 1.4 s, (frames - 1) hops
    assert sr == 24000 and abs(len(wav) / sr - 1.4) < 0.05 and np.isfinite(wav).all()


def test_socket_server_stream(ref_wav_path):
    """A streamed request through the socket server (any free port) and the
    client: the float32 stream ends with END and holds the audio; shutting
    the listening socket down stops the server."""
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.socket_client import listen_to_f5tts
    from f5_tts_tpu_torch.infer.socket_server import TTSStreamingProcessor, listen, serve_socket

    tts = F5TTS(model="F5TTS_Tiny", init_random=True, nfe_step=2, device="cpu")
    proc = TTSStreamingProcessor(tts, ref_wav_path, "a simple tone reference.")
    sock = listen("127.0.0.1", 0)
    port = sock.getsockname()[1]
    th = threading.Thread(target=serve_socket, args=(sock, proc), daemon=True)
    th.start()
    try:
        wav = listen_to_f5tts("stream me some audio please. And a second sentence.",
                              "127.0.0.1", port)
    finally:
        sock.shutdown(socket.SHUT_RDWR)
        sock.close()
        th.join(timeout=30)
    assert not th.is_alive()
    assert len(wav) > 1000 and np.isfinite(wav).all()


def test_vocoder_name_must_agree_with_the_config(ref_wav_path, tmp_path):
    """The vocoder follows the model config's mel_spec_type, which JAX's CLI
    parses --vocoder_name beside and never reads; the port refuses a flag
    that disagrees before building anything, and takes one that agrees."""
    args = ["--ref_audio", ref_wav_path, "--ref_text", "a tone.", "--gen_text", "hi.",
            "--output_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="disagrees"):
        C.main(TINY + ["--vocoder_name", "bigvgan"] + args)
    out = C.main(TINY + ["--vocoder_name", "vocos"] + args)
    assert os.path.isfile(out)
    yaml_path = tmp_path / "bigvgan.yaml"
    yaml_path.write_text(
        "model:\n  name: TinyBigVGAN\n  backbone: DiT\n  tokenizer: char\n"
        "  arch:\n    dim: 64\n    depth: 2\n    heads: 4\n    dim_head: 16\n"
        "    ff_mult: 2\n    text_dim: 32\n    conv_layers: 1\n    mel_dim: 100\n"
        "  mel_spec:\n    mel_spec_type: bigvgan\n")
    assert C._mel_spec_type("F5TTS_Tiny", str(yaml_path)) == "bigvgan"
    with pytest.raises(ValueError, match="disagrees"):
        C.main(["--model_cfg", str(yaml_path), "--vocoder_name", "vocos"] + TINY[2:] + args)
