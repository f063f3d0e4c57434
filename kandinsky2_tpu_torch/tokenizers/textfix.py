"""Minimal ftfy-equivalent text repair (pure stdlib), a copy of
``kandinsky2_tpu/tokenizers/textfix.py``.

The reference tokenizes prompts through openai-clip, whose whitespace_clean
pipeline starts with ``ftfy.fix_text`` (mojibake repair).  ftfy is an
optional dependency; where it is absent this module implements its two
load-bearing fixes so mojibake prompts tokenize identically to the
reference:

1. UTF-8-decoded-as-cp1252/latin-1 repair ("LÃ³pez" -> "López",
   "â€œquotedâ€\x9d" -> curly quotes), applied iteratively for
   double-encoded text.
2. Unicode NFC normalization (ftfy's default ``normalization='NFC'``).

HTML entity unescaping is handled by the caller (clip_bpe._clean), matching
openai-clip's ``html.unescape(html.unescape(text))``.
"""

from __future__ import annotations

import unicodedata



def _sloppy_cp1252_encode(text: str) -> bytes | None:
    """cp1252 per-character, falling back to latin-1 for cp1252's five holes
    (0x81 0x8D 0x8F 0x90 0x9D) — ftfy's 'sloppy-windows-1252'.  Real-world
    mojibake mixes both: the mis-decoder that produced it used cp1252 for
    printable bytes and passed C1 controls through."""
    out = bytearray()
    for ch in text:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            cp = ord(ch)
            if cp <= 0xFF:
                out.append(cp)
            else:
                return None
    return bytes(out)


def _try_refix(text: str) -> str | None:
    """One round of encode-as-legacy / decode-as-utf8; None if impossible."""
    raw = _sloppy_cp1252_encode(text)
    if raw is not None:
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            pass
    try:
        return text.encode("latin-1").decode("utf-8")
    except (UnicodeEncodeError, UnicodeDecodeError):
        return None


def fix_text(text: str, max_rounds: int = 3) -> str:
    """Repair mojibake and NFC-normalize, approximating ftfy.fix_text for
    prompt-sized strings.

    Acceptance rule: a repair round is kept only when the legacy-encode /
    UTF-8-decode round-trip succeeds AND strictly shortens the string (every
    real mojibake fix collapses 2-4 chars into 1).  Clean accented text
    ("não", "été" typed literally as words) fails the round-trip decode and
    passes through untouched."""
    if text.isascii():
        return text
    for _ in range(max_rounds):
        fixed = _try_refix(text)
        if fixed is None or len(fixed) >= len(text):
            break
        text = fixed
    return unicodedata.normalize("NFC", text)
