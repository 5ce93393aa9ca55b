"""Hotword context-biasing graph for CTC prefix beam search (the port's own
copy of ``tpuasr/decode/context_graph.py``; numpy, host side).

The trie of hotwords with Aho-Corasick fail links is closed on the host
into two dense tables, ``next_state [num_nodes, V]`` and ``score_delta
[num_nodes, V]``, so extending a prefix by token u from graph state s is a
gather: state ``next_state[s, u]``, score ``+ score_delta[s, u]``.
``finalize_score[s]`` removes the bonus of a partial match still open at
the end (wenet context_graph.py `finalize` parity)."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class ContextGraph:
    next_state: np.ndarray  # [N, V] int32
    score_delta: np.ndarray  # [N, V] float32
    node_score: np.ndarray  # [N] float32 accumulated partial-match bonus
    num_nodes: int

    @property
    def finalize_score(self) -> np.ndarray:
        """Score to add at the end of decode per state (removes the partial bonus)."""
        return -self.node_score


def build_context_graph(hotwords: list[list[int]], vocab_size: int,
                        context_score: float = 2.0) -> ContextGraph:
    """The dense automaton of token-id hotword sequences. Each matched token
    adds `context_score`; completing a hotword banks its bonus (the state
    falls back through its suffix link); breaking a partial match forfeits
    the partial bonus (score_delta against the fail target's score)."""
    children: list[dict[int, int]] = [{}]
    depth = [0]
    is_end = [False]
    for seq in hotwords:
        node = 0
        for tok in seq:
            if tok not in children[node]:
                children.append({})
                depth.append(depth[node] + 1)
                is_end.append(False)
                children[node][tok] = len(children) - 1
            node = children[node][tok]
        is_end[node] = True

    n = len(children)
    fail = np.zeros(n, np.int32)
    q = deque(children[0].values())
    while q:
        u = q.popleft()
        for tok, ch in children[u].items():
            # fail link: the longest proper suffix that is also a trie prefix
            f = fail[u]
            while f != 0 and tok not in children[f]:
                f = fail[f]
            fail[ch] = children[f][tok] if (tok in children[f] and children[f][tok] != ch) else 0
            q.append(ch)

    node_score = np.array([depth[i] * context_score for i in range(n)], np.float32)
    next_state = np.zeros((n, vocab_size), np.int32)
    score_delta = np.zeros((n, vocab_size), np.float32)
    for u in range(n):
        for tok in range(vocab_size):
            s = u
            while s != 0 and tok not in children[s]:
                s = fail[s]
            v = children[s].get(tok, 0)
            # a transition scores the change in un-banked partial bonus; a
            # completed hotword banks its bonus, falls back to its suffix
            # state and credits that suffix's partial bonus anew
            if is_end[v]:
                score_delta[u, tok] = node_score[v] - node_score[u] + node_score[fail[v]]
                next_state[u, tok] = fail[v]
            else:
                score_delta[u, tok] = node_score[v] - node_score[u]
                next_state[u, tok] = v
    return ContextGraph(next_state, score_delta, node_score, n)
