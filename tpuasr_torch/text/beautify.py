"""Host-side readable-text assembly for mixed CJK/English hypotheses (the
port's own copy of ``tpuasr/text/beautify.py``).

Behaves as wenet/paraformer/search.py:57-110 (`paraformer_beautify_result`).
The reference dispatches to three near-identical branches (all-CJK,
all-alpha, mixed); the behavior is re-derived here as one single-pass state
machine with the same outputs: CJK characters adjoin, `@@`-suffixed BPE
pieces merge into the following word, completed English words are
space-separated, and a CJK character directly after an English word absorbs
the separating space.

Two reference quirks are reproduced deliberately (both verified against the
wenet branches): (1) a pending `@@` prefix interrupted by a CJK character is
emitted with the *next* completed word, after the CJK character
(search.py:95-100: `word_item` is not flushed on the CJK branch); (2) a
hypothesis ending on an unterminated `@@` piece drops that fragment
(neither branch flushes `word_item` after the loop).
"""

from __future__ import annotations

import re
from typing import Iterable

_CJK_CHAR = re.compile(r"[一-鿿]")
_SPECIALS = {"<sos>", "<eos>", "<blank>", "<s>", "</s>", "<unk>", "<OOV>"}


def _is_cjk(tok: str) -> bool:
    return bool(tok) and all(_CJK_CHAR.fullmatch(c) for c in tok)


def _is_alpha(tok: str) -> bool:
    body = tok.replace("@@", "")
    return bool(body) and all(
        (c.isalpha() and not _CJK_CHAR.fullmatch(c)) or c == "'" for c in body
    )


def beautify_result(tokens: Iterable[str]) -> str:
    """Join decoded subword tokens into display text."""
    pieces: list[str] = []
    word = ""  # pending @@-continued word prefix
    after_alpha_space = False
    for tok in tokens:
        if tok in _SPECIALS:
            continue
        if _is_cjk(tok):
            if after_alpha_space:
                pieces.pop()  # CJK adjoins the preceding English word
            pieces.append(tok)
            after_alpha_space = False
        elif "@@" in tok and _is_alpha(tok):
            word += tok.replace("@@", "")
            after_alpha_space = False
        elif _is_alpha(tok):
            pieces.append(word + tok)
            pieces.append(" ")
            word = ""
            after_alpha_space = True
        else:
            pieces.append(tok)
            after_alpha_space = False
    return "".join(pieces).strip()
