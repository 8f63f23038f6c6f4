"""Tokenizers: char/pinyin vocab mapping and byte tokenizer.

Mirrors reference src/f5_tts/model/utils.py:92-142: vocab.txt line i -> index i,
space must be index 0 (doubles as the unknown-char id); sequences are padded
with -1 (the backbone shifts +1 so -1 becomes the filler token 0).

The bundled ``data/vocab.txt`` is the Emilia ZH+EN pinyin vocab (2545 tokens)
shipped with the released checkpoints — it is model-interface data, identical
by necessity for checkpoint compatibility.
"""

from __future__ import annotations

import os

import numpy as np

_PKG_VOCAB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "vocab.txt")


def load_vocab(path: str | None = None) -> dict[str, int]:
    """vocab.txt -> {token: index}.  Line content excludes only the trailing
    newline, so ' ' (space) stays a valid token."""
    path = path or _PKG_VOCAB
    vocab = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line[:-1] if line.endswith("\n") else line] = i
    return vocab


def get_tokenizer(dataset_name_or_path: str | None = None, tokenizer: str = "pinyin"):
    """Returns (vocab_char_map | None, vocab_size).

    tokenizer: "pinyin" | "char" -> vocab.txt mapping (default: bundled Emilia
    vocab); "byte" -> utf-8 bytes (size 256); "custom" -> path to a vocab.txt.
    """
    if tokenizer in ("pinyin", "char"):
        path = None
        if dataset_name_or_path and os.path.isfile(dataset_name_or_path):
            path = dataset_name_or_path
        elif dataset_name_or_path:
            cand = os.path.join("data", f"{dataset_name_or_path}_{tokenizer}", "vocab.txt")
            if os.path.isfile(cand):
                path = cand
        vocab = load_vocab(path)
        if " " in vocab:
            assert vocab[" "] == 0, "space must be index 0 in vocab.txt (used as unknown id)"
        return vocab, len(vocab)
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab = load_vocab(dataset_name_or_path)
        return vocab, len(vocab)
    raise ValueError(f"unknown tokenizer: {tokenizer}")


def tokens_to_ids(
    texts: list[str] | list[list[str]],
    vocab: dict[str, int] | None,
    pad_value: int = -1,
) -> np.ndarray:
    """List of token sequences -> [b, nt] int32, -1 padded.

    With a vocab map, unknown tokens map to 0 (reference list_str_to_idx);
    without one, tokens are utf-8 bytes (reference list_str_to_tensor).
    """
    if vocab is not None:
        rows = [[vocab.get(c, 0) for c in t] for t in texts]
    else:
        rows = [list(bytes("".join(t) if isinstance(t, list) else t, "utf-8")) for t in texts]
    nt = max((len(r) for r in rows), default=1)
    out = np.full((len(rows), max(nt, 1)), pad_value, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
