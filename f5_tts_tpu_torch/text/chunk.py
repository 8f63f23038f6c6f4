"""Long-text chunking (reference src/f5_tts/infer/utils_infer.py:73-102):
sentence-split on latin/CJK punctuation, greedy pack by utf-8 byte budget."""

from __future__ import annotations

import re


def _hard_split(piece: str, max_chars: int) -> list[str]:
    """Word-boundary (fallback: codepoint-boundary) split to <= ``max_chars``
    utf-8 bytes per piece.  Used for TTFB-critical first packages: the
    punctuation-only splitter keeps an over-long clause whole, which silently
    promotes the first streamed chunk to a bigger duration bucket."""
    words = re.findall(r"\S+\s*", piece)
    out: list[str] = []
    cur = ""
    for w in words:
        if cur and len((cur + w).encode("utf-8")) > max_chars:
            out.append(cur.strip())
            cur = ""
        cur += w
        while len(cur.encode("utf-8")) > max_chars:  # over-long word / CJK run
            k = len(cur)
            while k > 1 and len(cur[:k].encode("utf-8")) > max_chars:
                k -= 1
            out.append(cur[:k].strip())
            cur = cur[k:]
    if cur.strip():
        out.append(cur.strip())
    return [c for c in out if c]


def chunk_text(text: str, max_chars: int = 135, hard_max: bool = False) -> list[str]:
    """Split ``text`` into chunks of at most ``max_chars`` utf-8 bytes each
    (sentence boundaries preserved).  With ``hard_max=True``, chunks that a
    punctuation split cannot shrink below the budget (one long clause) are
    further split at word boundaries so the byte bound actually holds — the
    reference's first-package shrink (socket_server.py:139-142) re-chunks at
    max/2 then max/4 but stays punctuation-bound, so a single 100-byte clause
    defeats it."""
    chunks: list[str] = []
    current = ""
    sentences = re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text)
    for sentence in sentences:
        if not sentence:
            continue
        latin_end = bool(sentence) and len(sentence[-1].encode("utf-8")) == 1
        piece = sentence + " " if latin_end else sentence
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += piece
        else:
            if current:
                chunks.append(current.strip())
            current = piece
    if current:
        chunks.append(current.strip())
    # drop whitespace-only chunks (the reference can emit one for degenerate
    # whitespace input; an empty chunk would synthesize a junk blob)
    chunks = [c for c in chunks if c]
    if hard_max:
        chunks = [p for c in chunks for p in _hard_split(c, max_chars)]
    return chunks
