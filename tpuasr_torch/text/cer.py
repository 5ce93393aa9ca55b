"""Character error rate with substitution/deletion/insertion breakdown (the
port's own copy of ``tpuasr/text/cer.py``).

Levenshtein DP with a backtrace counting S/D/I; corpus CER = sum(S+D+I) /
sum(len(ref)). The backtrace breaks ties in one fixed order, substitution or
match first, then deletion, then insertion, so equal distances always split
into the same S/D/I counts. NumPy on the host, one utterance at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class CerCounts:
    substitutions: int
    deletions: int
    insertions: int
    ref_len: int

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def cer(self) -> float:
        return self.errors / max(self.ref_len, 1)

    def __add__(self, other: "CerCounts") -> "CerCounts":
        return CerCounts(
            self.substitutions + other.substitutions,
            self.deletions + other.deletions,
            self.insertions + other.insertions,
            self.ref_len + other.ref_len,
        )


def cer_details(ref: Sequence, hyp: Sequence) -> CerCounts:
    """Edit-distance alignment of one (ref, hyp) pair with S/D/I counts."""
    n, m = len(ref), len(hyp)
    # dp[i, j] = min edits to turn ref[:i] into hyp[:j]
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        ri = ref[i - 1]
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (ri != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # backtrace
    s = d = ins = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                s += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            d += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return CerCounts(s, d, ins, n)


def corpus_cer(pairs: Sequence[tuple[Sequence, Sequence]]) -> CerCounts:
    """Aggregate CER over (ref, hyp) pairs: sum(S+D+I)/sum(N)."""
    total = CerCounts(0, 0, 0, 0)
    for ref, hyp in pairs:
        total = total + cer_details(ref, hyp)
    return total
