"""Tokenizers (the port's own copy of ``tpuasr/text/tokenizer.py``).

Six special tokens ``<pad> <unk> <sos> <eos> " " <blk>`` occupy ids 0-5, the
vocabulary follows: a vocabulary file's lines in order, a token list, or
without either the built-in pinyin table (409 syllables, so size 415).
Encoding maps unknown tokens to ``<unk>``; decoding skips specials.
`CharTokenizer` tokenizes character-level Mandarin the way wenet's
char_tokenizer does, with bracketed non-linguistic symbols kept whole.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

from tpuasr_torch.text.pinyin import PINYIN_SYLLABLES

SPECIAL_TOKENS = ("<pad>", "<unk>", "<sos>", "<eos>", " ", "<blk>")

PAD, UNK, SOS, EOS, SPACE, BLK = range(6)


class Tokenizer:
    """Vocabulary-file tokenizer over whitespace-split symbol sequences."""

    def __init__(self, vocab_file: str | None = None, tokens: Iterable[str] | None = None):
        self.token2id: dict[str, int] = {}
        self.id2token: dict[int, str] = {}
        for tok in SPECIAL_TOKENS:
            self._add(tok)
        if vocab_file is not None:
            with open(vocab_file, encoding="utf-8") as f:
                for line in f:
                    tok = line.strip()
                    if tok:
                        self._add(tok)
        elif tokens is not None:
            for tok in tokens:
                self._add(tok)
        else:
            for tok in PINYIN_SYLLABLES:
                self._add(tok)

    def _add(self, tok: str) -> None:
        if tok not in self.token2id:
            i = len(self.token2id)
            self.token2id[tok] = i
            self.id2token[i] = tok

    def __call__(self, tokens: Sequence[str]) -> list[int]:
        unk = self.token2id["<unk>"]
        return [self.token2id.get(t, unk) for t in tokens]

    def encode(self, tokens: Sequence[str]) -> list[int]:
        return self(tokens)

    def decode(self, ids: Iterable[int], ignore_special: bool = True) -> list[str]:
        out = []
        for i in ids:
            tok = self.id2token.get(int(i))
            if tok is None:
                if not ignore_special:
                    out.append("<unk>")
                continue
            if ignore_special and tok in SPECIAL_TOKENS:
                continue
            out.append(tok)
        return out

    def special_token_ids(self) -> list[int]:
        return [self.token2id[t] for t in SPECIAL_TOKENS]

    @property
    def size(self) -> int:
        return len(self.token2id)

    @property
    def pad_id(self) -> int:
        return PAD

    @property
    def sos_id(self) -> int:
        return SOS

    @property
    def eos_id(self) -> int:
        return EOS

    @property
    def blk_id(self) -> int:
        return BLK


# wenet non-linguistic-symbol shapes: {NOISE} / <NOISE> / [NOISE]
# (wenet/text/char_tokenizer.py:22, wenet/utils/file_utils.py:47)
_NON_LANG_RE = re.compile(r"(\[[^\[\]]+\]|<[^<>]+>|{[^{}]+})")


def read_non_lang_symbols(path: str | None) -> list[str]:
    """One symbol per line, each shaped {xxx}/<xxx>/[xxx]
    (wenet/utils/file_utils.py `read_non_lang_symbols`:26-59)."""
    if path is None:
        return []
    syms = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            sym = line.strip()
            if not sym:
                continue
            if _NON_LANG_RE.fullmatch(sym) is None:
                raise ValueError(
                    f"non-linguistic symbol {sym!r} must be formatted "
                    "{xxx}, <xxx>, or [xxx]"
                )
            syms.append(sym)
    return syms


class CharTokenizer(Tokenizer):
    """Character-level tokenizer (wenet/text/char_tokenizer.py:9-79 parity).

    `non_lang_syms` (a list or a file path, wenet file_utils.py
    `read_non_lang_symbols`) protects bracketed symbols — ``{NOISE}``,
    ``<NOISE>``, ``[NOISE]`` — from character splitting: the regex splits
    them out first and only *listed* symbols survive as single tokens.
    Without the list, any ``<...>`` span is kept intact (lenient default so
    the framework's own specials round-trip; wenet would char-split them).
    `connect_symbol` joins tokens back into text (`tokens2text`); spaces
    inside text map to the ``▁`` word-boundary character as in wenet, and
    `split_with_space` treats the text as pre-tokenized on whitespace."""

    def __init__(self, vocab_file: str | None = None,
                 tokens: Iterable[str] | None = None,
                 non_lang_syms: str | list[str] | None = None,
                 split_with_space: bool = False,
                 connect_symbol: str = ""):
        super().__init__(vocab_file, tokens)
        if isinstance(non_lang_syms, str):
            non_lang_syms = read_non_lang_symbols(non_lang_syms)
        self.non_lang_syms = list(non_lang_syms or [])
        self.split_with_space = split_with_space
        self.connect_symbol = connect_symbol

    def tokenize_text(self, text: str) -> list[str]:
        text = text.strip()
        if self.non_lang_syms:
            # wenet char_tokenizer.py:40-43: split protected symbols out
            # (uppercased text, as wenet does), keep listed ones whole
            parts = [p.strip() for p in _NON_LANG_RE.split(text.upper())
                     if p.strip()]
            tokens: list[str] = []
            for part in parts:
                if part in self.non_lang_syms:
                    tokens.append(part)
                    continue
                units = part.split(" ") if self.split_with_space else part
                for ch in units:
                    tokens.append("▁" if ch == " " else ch)
            return tokens
        # lenient default: any <...> span survives as one token
        parts: list[str] = []
        i = 0
        while i < len(text):
            if text[i] == "<":
                j = text.find(">", i)
                if j != -1:
                    parts.append(text[i : j + 1])
                    i = j + 1
                    continue
            if not text[i].isspace():
                parts.append(text[i])
            i += 1
        return parts

    def tokens2text(self, tokens: Sequence[str]) -> str:
        """wenet char_tokenizer.py:59-60: join with `connect_symbol`."""
        return self.connect_symbol.join(tokens)

    def encode_text(self, text: str) -> list[int]:
        return self(self.tokenize_text(text))
