"""Chinese G2P: char -> pinyin conversion for the pinyin tokenizer.

Mirrors reference src/f5_tts/model/utils.py:148-185 (rjieba word segmentation +
pypinyin TONE3 with tone sandhi).  TPU build uses:

- ``jieba`` (pure-python, same dictionary family as rjieba) for segmentation;
- pinyin lookup backends, in priority order:
    1. ``pypinyin`` (lazy_pinyin, Style.TONE3, tone_sandhi=True) if installed —
       exact reference parity;
    2. the BUNDLED table (data/pinyin_table.tsv, ~5.8k chars + ~400 polyphone
       word overrides curated in scripts/pinyin_data{,_ext}.py, every syllable
       validated against the Emilia vocab; 0.084% frequency-weighted
       identity-fallback rate on the jieba dictionary corpus) or a user-supplied file via
       $F5_TTS_TPU_PINYIN_TABLE / ``set_pinyin_table``; tone sandhi (3-3,
       不, 一 — the rules pypinyin's tone_sandhi applies per word) runs
       natively, so zh G2P works out-of-the-box with no optional deps;
    3. identity fallback (emits the raw char) with a one-time warning.

Table file format: ``entry<TAB>pinyin`` per line; ``entry`` is one char or a
word (value then holds space-separated per-char syllables).  Neutral tones
carry no digit (pypinyin TONE3 convention; such tokens are OOV in the vocab
and map to 0, same as the reference).
"""

from __future__ import annotations

import os
import warnings

_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})

_table: dict[str, str] | None = None
_backend: str | None = None
_warned = False


def is_chinese(c: str) -> bool:
    return "㄀" <= c <= "鿿"


def set_pinyin_table(path: str) -> None:
    global _table, _backend
    table = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                table[parts[0]] = parts[1]
    _table = table
    _backend = "table"


def _resolve_backend() -> str:
    global _backend, _table
    if _backend is not None:
        return _backend
    try:
        import pypinyin  # noqa: F401

        _backend = "pypinyin"
        return _backend
    except ImportError:
        pass
    path = os.environ.get("F5_TTS_TPU_PINYIN_TABLE")
    if path and os.path.isfile(path):
        set_pinyin_table(path)
        return _backend
    pkg_table = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "pinyin_table.tsv")
    if os.path.isfile(pkg_table):
        set_pinyin_table(pkg_table)
        return _backend
    _backend = "identity"
    return _backend


def _apply_sandhi(seg: str, syls: list[str]) -> list[str]:
    """Mandarin tone sandhi within one word, mirroring the rules pypinyin's
    ``tone_sandhi=True`` applies per lazy_pinyin call (reference
    model/utils.py:179): consecutive third tones 3-3 -> 2-3; 不 -> bu2 before
    tone 4; 一 -> yi2 before tone 4, yi4 before tones 1/2/3."""
    out = list(syls)
    for i in range(len(out) - 1):
        if out[i][-1:] == "3" and out[i + 1][-1:] == "3":
            out[i] = out[i][:-1] + "2"
    for i, ch in enumerate(seg[:-1]):
        if i >= len(out) - 1:
            break
        nxt_tone = out[i + 1][-1:]
        if ch == "不" and nxt_tone == "4":
            out[i] = "bu2"
        elif ch == "一":
            if nxt_tone == "4":
                out[i] = "yi2"
            elif nxt_tone in "123":
                out[i] = "yi4"
    return out


def _pinyin_seg(seg: str) -> list[str]:
    """Pinyin for a pure-CJK segment, one syllable per char."""
    global _warned
    backend = _resolve_backend()
    if backend == "pypinyin":
        from pypinyin import Style, lazy_pinyin

        return lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)
    if backend == "table":
        word = _table.get(seg)
        if word is not None and len(seg) > 1:
            return _apply_sandhi(seg, word.split())
        syls = [(_table.get(c, c) or c).split()[0] for c in seg]
        return _apply_sandhi(seg, syls)
    if not _warned:
        warnings.warn(
            "No pinyin backend available (pypinyin not installed, no table file);"
            " Chinese characters pass through unconverted. Provide"
            " $F5_TTS_TPU_PINYIN_TABLE for zh support.",
            stacklevel=2,
        )
        _warned = True
    return list(seg)


def _segment(text: str) -> list[str]:
    # native C++ segmenter (rjieba-equivalent, HMM disabled); falls back to
    # python jieba / passthrough internally
    from f5_tts_tpu_torch.text.segmenter import cut

    return cut(text)


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    """Reference-parity token-list conversion (model/utils.py:148-185):
    mixed zh/en handling, space insertion before CJK syllables and between
    multi-char latin words."""
    out = []
    for text in text_list:
        char_list: list[str] = []
        text = text.translate(_CUSTOM_TRANS)
        for seg in _segment(text):
            seg_byte_len = len(bytes(seg, "UTF-8"))
            if seg_byte_len == len(seg):  # pure alphabets / symbols
                if char_list and seg_byte_len > 1 and char_list[-1] not in " :'\"":
                    char_list.append(" ")
                char_list.extend(seg)
            elif polyphone and seg_byte_len == 3 * len(seg):  # pure CJK
                seg_py = _pinyin_seg(seg)
                for i, c in enumerate(seg):
                    if is_chinese(c):
                        char_list.append(" ")
                    char_list.append(seg_py[i])
            else:  # mixed
                for c in seg:
                    if ord(c) < 256:
                        char_list.extend(c)
                    elif is_chinese(c):
                        char_list.append(" ")
                        char_list.extend(_pinyin_seg(c))
                    else:
                        char_list.append(c)
        out.append(char_list)
    return out
