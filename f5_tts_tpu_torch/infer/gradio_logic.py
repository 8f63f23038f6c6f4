"""Pure (gradio-free) logic for the inference web UI.

Everything the reference implements inline in its 1.1k-LoC app
(``src/f5_tts/infer/infer_gradio.py``) that is actually *behavior* —
multi-style script parsing, speech-type bookkeeping, validation, seed
normalization, custom-model persistence, result caching — lives here so it
can be unit-tested without a gradio install.  ``gradio_app.py`` is a thin
shell over these helpers.

Reference behavior spec:
- parse_speechtypes_text: infer_gradio.py:349-380
- speech-type collection/placeholders: infer_gradio.py:611-631
- validation (missing types disable Generate): infer_gradio.py:707-731
- seed normalization (0..2**31-1, random on out-of-range): infer_gradio.py:146-152
- last-used custom model persistence: infer_gradio.py:978-1010
- lru-cached infer on hashable params: infer_gradio.py:131

JAX counterpart: ``f5_tts_tpu/infer/gradio_logic.py`` (a copy; it imports
nothing of either package).
"""

from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

MAX_SEED = 2**31 - 1

#: (ckpt, vocab, model_cfg_json) defaults mirroring the reference's
#: DEFAULT_TTS_MODEL_CFG (infer_gradio.py:50-62) with local-path slots.
DEFAULT_CUSTOM_MODEL_CFG = (
    "",
    "",
    json.dumps(
        dict(
            dim=1024,
            depth=22,
            heads=16,
            ff_mult=2,
            text_dim=512,
            text_mask_padding=True,
            conv_layers=4,
        )
    ),
)

#: Preset architecture JSONs offered in the custom-config dropdown
#: (reference infer_gradio.py:1037-1068).
CUSTOM_MODEL_CFG_CHOICES = (
    DEFAULT_CUSTOM_MODEL_CFG[2],
    json.dumps(
        dict(
            dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
            text_mask_padding=False, conv_layers=4, pe_attn_head=1,
        )
    ),
    json.dumps(
        dict(
            dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
            text_mask_padding=False, conv_layers=4, pe_attn_head=1,
        )
    ),
)


def parse_speechtypes_text(gen_text: str) -> list[dict]:
    """Split a multi-style script into per-segment dicts.

    Markers are ``{Name}`` or ``{"name": ..., "seed": int, "speed": float}``;
    the current type carries forward until the next marker; the default type
    is Regular with seed -1 (random) and speed 1.0.
    Matches reference infer_gradio.py:349-380.
    """
    tokens = re.split(r"(\{.*?\})", gen_text)
    segments: list[dict] = []
    current = {"name": "Regular", "seed": -1, "speed": 1.0}
    for i, tok in enumerate(tokens):
        if i % 2 == 0:
            text = tok.strip()
            if text:
                seg = dict(current)
                seg["text"] = text
                segments.append(seg)
        else:
            marker = tok.strip()
            try:
                current = json.loads(marker)
            except json.JSONDecodeError:
                current = {"name": marker[1:-1], "seed": -1, "speed": 1.0}
    return segments


def collect_speech_types(names, audios, ref_texts) -> "OrderedDict[str, dict]":
    """Zip parallel UI rows into an ordered name->{audio, ref_text} dict.

    Rows missing a name or audio become ``@i@`` placeholders so the output
    row order (updated ref texts are written back per-row) is preserved.
    Matches reference infer_gradio.py:617-631.
    """
    speech_types: OrderedDict[str, dict] = OrderedDict()
    for i, (name, audio, ref_text) in enumerate(zip(names, audios, ref_texts)):
        if name and audio:
            speech_types[name] = {"audio": audio, "ref_text": ref_text}
        else:
            speech_types[f"@{i}@"] = {"audio": "", "ref_text": ""}
    return speech_types


def missing_speech_types(gen_text: str, regular_name: str, *names: str) -> set[str]:
    """Speech types referenced in the script but not configured.

    Non-empty result should disable the Generate button
    (reference infer_gradio.py:707-731).
    """
    available = {n for n in (regular_name, *names) if n}
    used = {seg["name"] for seg in parse_speechtypes_text(gen_text)}
    return used - available


def normalize_seed(seed: int, randomize: bool = False, rng=np.random) -> int:
    """Clamp/draw the inference seed the way the reference UI does.

    ``randomize`` or out-of-range [0, 2**31-1] -> fresh random seed
    (reference infer_gradio.py:146-152 and the randomize_seed checkbox).
    """
    if randomize or seed < 0 or seed > MAX_SEED:
        return int(rng.randint(0, MAX_SEED))
    return int(seed)


def load_text_from_file(path: str | None) -> str:
    """Read a .txt upload into the gen-text box (infer_gradio.py:121-128)."""
    if not path:
        return ""
    with open(path, encoding="utf-8") as f:
        return f.read().strip()


def default_cache_path() -> str:
    return os.path.join(
        os.path.expanduser("~"), ".cache", "f5_tts_tpu", "last_used_custom_model_info_v1.txt"
    )


def load_last_used_custom(path: str | None = None) -> tuple[str, str, str]:
    """Load the persisted (ckpt, vocab, model_cfg) triple, or defaults.

    Matches reference infer_gradio.py:980-989 (one value per line).
    """
    path = path or default_cache_path()
    try:
        with open(path, encoding="utf-8") as f:
            lines = [line.strip() for line in f]
    except FileNotFoundError:
        return DEFAULT_CUSTOM_MODEL_CFG
    lines += [""] * (3 - len(lines))
    return lines[0], lines[1], lines[2]


def save_last_used_custom(ckpt: str, vocab: str, model_cfg: str, path: str | None = None) -> None:
    """Persist the custom-model triple (reference infer_gradio.py:1005-1010)."""
    path = path or default_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(ckpt + "\n" + vocab + "\n" + model_cfg + "\n")


@dataclass
class InferCache:
    """Repeat-call result cache keyed on the hashable inference params.

    The reference wraps its module-level ``infer`` in ``lru_cache(1000)``
    (infer_gradio.py:131) so regenerating an unchanged segment (multi-style
    scripts re-run every segment on each click) is free.  A dict + FIFO
    eviction keeps this picklable and easy to introspect in tests.
    """

    maxsize: int = 1000
    _store: "OrderedDict[tuple, object]" = field(default_factory=OrderedDict)
    hits: int = 0
    misses: int = 0

    def get_or_compute(self, key: tuple, compute):
        if key in self._store:
            self.hits += 1
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        value = compute()
        self._store[key] = value
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
        return value


def conversation_add_user(conv_state: list[dict], text: str) -> list[dict]:
    """Append a user turn (reference process_audio_input, infer_gradio.py:851-864)."""
    text = (text or "").strip()
    if text:
        conv_state = conv_state + [{"role": "user", "content": text}]
    return conv_state


def last_assistant_reply(conv_state: list[dict]) -> str | None:
    """The reply to speak, or None (reference generate_audio_response :881-887)."""
    if not conv_state or conv_state[-1].get("role") != "assistant":
        return None
    content = conv_state[-1].get("content")
    if isinstance(content, list):  # gradio "messages" content blocks
        content = content[0].get("text") if content else None
    return content or None


DEFAULT_CHAT_SYSTEM_PROMPT = (
    "You are not an AI assistant, you are whoever the user says you are. "
    "You must stay in character. Keep your responses concise since they will "
    "be spoken out loud."
)
