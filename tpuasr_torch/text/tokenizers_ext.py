"""The pure-Python tokenizers of the JAX package's tokenizer zoo (port of
``tpuasr/text/tokenizers_ext.py``, wenet/text parity):

- `BaseTokenizer`, the wenet/text/base_tokenizer.py:7-41 contract
  (tokenize / detokenize / text2tokens / tokens2ids / vocab_size /
  symbol_table);
- `train_bpe` and `PureBpeTokenizer`: a merges-based BPE with the
  sentencepiece word-boundary marker and its trainer, no dependency;
- `tokenize_mixed`: CJK characters as single tokens, every other run
  through an encoder;
- `ParaformerTokenizer`: the seg-dict tokenizer
  (wenet/text/paraformer_tokenizer.py).

The JAX module's HuggingFace, tiktoken (whisper) and sentencepiece backends
are not copied: they need packages outside this port's dependencies. The
pinyin and character tokenizers are `tpuasr_torch.text.tokenizer`'s.
"""

from __future__ import annotations

import abc
import json
import re
from collections import Counter
from typing import Sequence


class BaseTokenizer(abc.ABC):
    def tokenize(self, line: str) -> tuple[list[str], list[int]]:
        tokens = self.text2tokens(line)
        return tokens, self.tokens2ids(tokens)

    def detokenize(self, ids: Sequence[int]) -> tuple[str, list[str]]:
        tokens = self.ids2tokens(ids)
        return self.tokens2text(tokens), tokens

    @abc.abstractmethod
    def text2tokens(self, line: str) -> list[str]: ...

    @abc.abstractmethod
    def tokens2text(self, tokens: Sequence[str]) -> str: ...

    @abc.abstractmethod
    def tokens2ids(self, tokens: Sequence[str]) -> list[int]: ...

    @abc.abstractmethod
    def ids2tokens(self, ids: Sequence[int]) -> list[str]: ...

    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @property
    @abc.abstractmethod
    def symbol_table(self) -> dict[str, int]: ...


_WB = "▁"  # sentencepiece word-boundary marker


def train_bpe(lines: Sequence[str], vocab_size: int,
              specials: Sequence[str] = ("<unk>",)) -> dict:
    """Train a byte-pair-encoding model: greedy most-frequent pair merges
    over whitespace-split words prefixed with the word-boundary marker.
    Returns {"vocab": [...], "merges": [[a, b], ...]} (JSON-serializable)."""
    words = Counter()
    for line in lines:
        for w in line.strip().split():
            words[_WB + w] += 1
    seqs = {w: tuple(w) for w in words}

    vocab = list(specials)
    seen = set(vocab)
    for seq in seqs.values():
        for ch in seq:
            if ch not in seen:
                seen.add(ch)
                vocab.append(ch)

    merges = []
    while len(vocab) < vocab_size:
        pairs = Counter()
        for w, seq in seqs.items():
            f = words[w]
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += f
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append([a, b])
        ab = a + b
        if ab not in seen:
            seen.add(ab)
            vocab.append(ab)
        new_seqs = {}
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new_seqs[w] = tuple(out)
        seqs = new_seqs
    return {"vocab": vocab, "merges": merges}


class PureBpeTokenizer(BaseTokenizer):
    """Dependency-free BPE (wenet/text/bpe_tokenizer.py contract): applies
    trained merges in rank order to word-boundary-marked words; unknown
    symbols map to <unk>."""

    def __init__(self, model: dict | str):
        if isinstance(model, str):
            with open(model) as f:
                model = json.load(f)
        self._vocab = list(model["vocab"])
        self._ranks = {tuple(m): i for i, m in enumerate(model["merges"])}
        self._symbols = {t: i for i, t in enumerate(self._vocab)}
        self._unk = self._symbols.get("<unk>", 0)

    def _encode_word(self, word: str) -> list[str]:
        seq = list(_WB + word)
        while len(seq) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            seq[best : best + 2] = [seq[best] + seq[best + 1]]
        return seq

    def _encode_run(self, run: str) -> list[str]:
        out = []
        for w in run.split():
            out.extend(self._encode_word(w))
        return out

    def text2tokens(self, line: str) -> list[str]:
        # CJK characters pass through as single tokens, BPE covers the rest
        # (wenet tokenize_by_bpe_model; no upper() — models here are trained
        # in-process on the corpus's own case, unlike wenet's uppercase sp)
        return tokenize_mixed(line.strip(), self._encode_run, upper=False)

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return "".join(tokens).replace(_WB, " ").strip()

    def tokens2ids(self, tokens: Sequence[str]) -> list[int]:
        return [self._symbols.get(t, self._unk) for t in tokens]

    def ids2tokens(self, ids: Sequence[int]) -> list[str]:
        return [self._vocab[int(i)] for i in ids]

    def vocab_size(self) -> int:
        return len(self._vocab)

    @property
    def symbol_table(self) -> dict[str, int]:
        return dict(self._symbols)


_CJK_RE = re.compile(r"([一-鿿])")


def tokenize_mixed(txt: str, encode_non_cjk, upper: bool = True) -> list[str]:
    """Mixed CJK/English tokenization: CJK characters become single tokens,
    every maximal non-CJK run is handed to `encode_non_cjk` (BPE pieces or
    seg-dict expansion) (wenet/text/tokenize_utils.py:18-65)."""
    tokens: list[str] = []
    chars = _CJK_RE.split(txt.upper() if upper else txt)
    for piece in chars:
        if not piece.strip():
            continue
        if _CJK_RE.fullmatch(piece):
            tokens.append(piece)
        else:
            tokens.extend(encode_non_cjk(piece))
    return tokens


class ParaformerTokenizer(BaseTokenizer):
    """Seg-dict tokenizer: words map to space-separated subunit sequences;
    unseen CJK text falls back to per-character units."""

    def __init__(self, symbol_table: dict[str, int], seg_dict: dict[str, str] | None = None):
        self._symbols = dict(symbol_table)
        self._ids = {v: k for k, v in self._symbols.items()}
        self.seg_dict = seg_dict or {}
        self.unk = "<unk>"

    def _encode_run(self, run: str) -> list[str]:
        out = []
        for word in run.split():
            if word in self.seg_dict:
                out.extend(self.seg_dict[word].split())
            else:
                out.append(word)
        return out

    def text2tokens(self, line):
        return tokenize_mixed(line.strip(), self._encode_run, upper=False)

    def tokens2text(self, tokens):
        return "".join(tokens)

    def tokens2ids(self, tokens):
        unk_id = self._symbols.get(self.unk, 0)
        return [self._symbols.get(t, unk_id) for t in tokens]

    def ids2tokens(self, ids):
        return [self._ids.get(int(i), self.unk) for i in ids]

    def vocab_size(self):
        return len(self._symbols)

    @property
    def symbol_table(self):
        return self._symbols
