"""CTC forced alignment (Viterbi over the blank-interleaved lattice) and the
token-timestamp helpers (port of ``tpuasr/decode/alignment.py``).

Parity: torchaudio.functional.forced_align as used by
wenet/utils/ctc_utils.py:106-119 (`force_align`), plus the token-timestamp
utilities (ctc_utils.py:36-93). `ctc_forced_align` is batched plain
PyTorch on the log-probs' device: the Viterbi deltas and backpointers in
one loop over time, the backtrace in one loop back; ties go to the first
of (stay, s-1, s-2), as XLA's argmax takes the first maximum. The timestamp
helpers run on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuasr_torch.losses.ctc import lattice_labels

_NEG = -1.0e30


def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor, input_lens: torch.Tensor,
                     label_lens: torch.Tensor, blank: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """log_probs [B, T, V], labels [B, U], lengths [B] -> (alignment [B, T]
    int64 of token ids per frame, blank included, scores [B] fp32 Viterbi
    log-prob). Frames >= input_len hold blank."""
    b, t, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    dev = log_probs.device
    lp = log_probs.float()
    lab = lattice_labels(labels.long(), blank)
    state = torch.arange(s, device=dev)[None, :]
    ll, il = label_lens.long().to(dev), input_lens.long().to(dev)
    neg = torch.full((), _NEG, device=dev)
    lp_states = lp.gather(2, lab[:, None, :].expand(b, t, s))
    lp_states = torch.where((state <= 2 * ll[:, None])[:, None, :], lp_states, neg)
    lab_m2 = F.pad(lab, (2, 0), value=blank)[:, :s]
    can_skip = (lab != blank) & (lab != lab_m2) & (state >= 2)

    delta = torch.full((b, s), _NEG, device=dev)
    delta[:, 0] = lp_states[:, 0, 0]
    delta[:, 1] = torch.where(ll > 0, lp_states[:, 0, 1], neg)
    psi = torch.zeros((t, b, s), dtype=torch.long, device=dev)
    for i in range(1, t):
        d1 = F.pad(delta, (1, 0), value=_NEG)[:, :s]
        d2 = torch.where(can_skip, F.pad(delta, (2, 0), value=_NEG)[:, :s], neg)
        best, choice = torch.stack([delta, d1, d2], dim=-1).max(dim=-1)
        active = (i < il)[:, None]
        delta = torch.where(active, best + lp_states[:, i], delta)
        psi[i] = torch.where(active, choice, 0)

    rows = torch.arange(b, device=dev)
    last_blank = delta[rows, 2 * ll]
    last_label = torch.where(ll > 0, delta[rows, (2 * ll - 1).clamp(min=0)], neg)
    final = torch.where(last_blank >= last_label, 2 * ll, (2 * ll - 1).clamp(min=0))
    scores = torch.maximum(last_blank, last_label)

    # backtrace from t = input_len - 1 down
    states = torch.zeros((b, t), dtype=torch.long, device=dev)
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    for i in range(t - 1, -1, -1):
        cur = torch.where(i == il - 1, final, cur)
        states[:, i] = torch.where(i < il, cur, 0)
        if i > 0:
            cur = cur - psi[i, rows, cur]
    align = lab.gather(1, states)
    valid = torch.arange(t, device=dev)[None, :] < il[:, None]
    return torch.where(valid, align, blank), scores


def token_timestamps(alignment, blank: int) -> list[list[int]]:
    """First frame index of each emitted token, per row of an alignment
    [B, T] (wenet ctc_utils.py:51-93 role)."""
    out = []
    for row in np.asarray(alignment.cpu() if isinstance(alignment, torch.Tensor) else alignment):
        times, prev = [], blank
        for t, a in enumerate(row):
            if a != blank and a != prev:
                times.append(t)
            prev = a
        out.append(times)
    return out


def replace_duplicates_with_blank(hyp, blank_id: int = 0) -> list[int]:
    """Separate repeated tokens with a blank so a frame alignment stays
    CTC-decodable (wenet ctc_utils.py:36-49)."""
    out, cur, n = [], 0, len(hyp)
    while cur < n:
        out.append(int(hyp[cur]))
        prev = cur
        cur += 1
        while cur < n and hyp[cur] == hyp[prev] and hyp[cur] != blank_id:
            out.append(blank_id)
            cur += 1
    return out


def gen_ctc_peak_time(hyp, blank_id: int = 0) -> list[int]:
    """Frame index of each run's first frame, blanks skipped
    (wenet ctc_utils.py:51-61)."""
    times, cur, n = [], 0, len(hyp)
    while cur < n:
        if hyp[cur] != blank_id:
            times.append(cur)
        prev = cur
        while cur < n and hyp[cur] == hyp[prev]:
            cur += 1
    return times


def gen_timestamps_from_peak(peaks, max_duration: float, frame_rate: float = 0.04,
                             max_token_duration: float = 1.0) -> list[tuple[float, float]]:
    """(start, end) seconds per token from CTC peak frames: boundaries at the
    midpoint between neighbouring peaks, clamped to max_token_duration/2 on
    each side (wenet ctc_utils.py:63-93)."""
    times, half, n = [], max_token_duration / 2, len(peaks)
    for i in range(n):
        if i == 0:
            start = max(0.0, peaks[0] * frame_rate - half)
        else:
            start = max((peaks[i - 1] + peaks[i]) / 2 * frame_rate, peaks[i] * frame_rate - half)
        if i == n - 1:
            end = min(max_duration, peaks[-1] * frame_rate + half)
        else:
            end = min((peaks[i] + peaks[i + 1]) / 2 * frame_rate, peaks[i] * frame_rate + half)
        times.append((start, end))
    return times
