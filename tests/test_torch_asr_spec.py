"""The Whisper fallback (audio/asr.py, ``F5TTS.transcribe`` and an empty
``ref_text``) and the spectrogram export of the port's ``F5TTS``, on the
CPU.  No Whisper weights exist here: a fake ``transformers`` module in
``sys.modules`` records what its ``pipeline`` is asked for."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import sys
import types

import numpy as np
import pytest

from f5_tts_tpu_torch.audio import asr
from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.infer.api import F5TTS

REF = "examples/assets/basic_ref_en.wav"


@pytest.fixture()
def fake_whisper(monkeypatch, tmp_path):
    """A fake ``transformers.pipeline`` (recording its arguments and each
    call's input) behind a Whisper snapshot path in $F5_TTS_TPU_WHISPER."""
    made, heard = [], []

    def pipeline(task, model, device):
        made.append(dict(task=task, model=model, device=device))

        def run(inputs, **kw):
            heard.append(dict(inputs, **kw))
            return {"text": "  some call me nature  "}

        return run

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(pipeline=pipeline))
    monkeypatch.setattr(asr, "_pipes", {})
    snapshot = str(tmp_path / "whisper-large-v3-turbo")
    monkeypatch.setenv("F5_TTS_TPU_WHISPER", snapshot)
    return snapshot, made, heard


@pytest.fixture(scope="module")
def tts():
    return F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=2)


def _clip(seconds: float):
    wav, sr = load_wav(REF)
    return wav[: int(seconds * sr)], sr


def test_empty_ref_text_reaches_whisper(tts, fake_whisper):
    snapshot, made, heard = fake_whisper
    wav, sr, _ = tts.infer(_clip(2.1), "", "Hi.", seed=0, show_info=lambda *a: None)
    assert made == [dict(task="automatic-speech-recognition", model=snapshot, device="cpu")]
    assert len(heard) == 1 and heard[0]["sampling_rate"] == 24000
    assert heard[0]["generate_kwargs"] == {"task": "transcribe"}
    assert tts.last_ref_text == "some call me nature. " and np.isfinite(wav).all()


def test_transcribe_calls_whisper(tts, fake_whisper):
    snapshot, made, heard = fake_whisper
    assert asr.whisper_available()
    assert tts.transcribe(_clip(1.5), language="en") == "some call me nature"
    assert made[0]["model"] == snapshot and made[0]["device"] == "cpu"
    assert heard[0]["generate_kwargs"] == {"task": "transcribe", "language": "en"}
    np.testing.assert_array_equal(heard[0]["raw"], _clip(1.5)[0])


def test_no_whisper_behaves_as_jax(tts, monkeypatch, tmp_path):
    """Nothing resolves (no path, an empty offline HF cache): the
    preprocessing raises its ValueError, as JAX's does, and
    ``transcribe`` raises RuntimeError."""
    monkeypatch.delenv("F5_TTS_TPU_WHISPER", raising=False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(tts, "hf_cache_dir", str(tmp_path))
    assert not asr.whisper_available(hf_cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="ref_text is empty"):
        tts.infer(_clip(1.7), "  ", "Hi.", seed=0, show_info=lambda *a: None)
    with pytest.raises(RuntimeError, match="no Whisper model"):
        tts.transcribe(_clip(1.7))


def test_file_spec_writes_a_png(tts, tmp_path):
    path = tmp_path / "spec.png"
    wav_path = tmp_path / "out.wav"
    _, _, spec = tts.infer(_clip(2.0), "Some call me nature.", "Hi there.", seed=1,
                           file_spec=str(path), file_wave=str(wav_path),
                           show_info=lambda *a: None)
    assert spec.shape[0] == 100 and wav_path.exists()
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
