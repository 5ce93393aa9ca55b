"""SpecAugment: time and frequency masking of fbank features inside the
train step (port of ``tpuasr/audio/specaug.py``).

`num_t_masks` time stripes and `num_f_masks` frequency stripes per
utterance, each of a width drawn from 0 to its maximum inclusive; a time
stripe starts anywhere in [0, T) and the start is clamped to the
utterance's last valid frame, so padding is never the only thing masked;
masked values become zero. The draws come from an explicit generator (the
JAX function's split keys become one generator drawn from in the same
order); the bits differ from JAX's, the distribution is the same.
"""

from __future__ import annotations

import torch


def spec_augment(gen: torch.Generator, feats: torch.Tensor, feat_lens: torch.Tensor,
                 num_t_masks: int = 2, num_f_masks: int = 2, max_t: int = 50,
                 max_f: int = 10) -> torch.Tensor:
    """feats [B, T, F], feat_lens [B] -> feats with the stripes zeroed. `gen`
    lies on the features' device, so the draws never wait for the host."""
    b, t, f = feats.shape
    dev = feats.device
    draw = lambda hi: torch.randint(0, hi, (b,), generator=gen, device=dev)
    t_idx = torch.arange(t, device=dev)[None, :]
    f_idx = torch.arange(f, device=dev)[None, :]
    last = (feat_lens.to(dev).long() - 1).clamp(min=0)
    keep = torch.ones((b, t, f), dtype=torch.bool, device=dev)
    for _ in range(num_t_masks):
        start = torch.minimum(draw(max(t, 1)), last)
        width = draw(max_t + 1)
        stripe = (t_idx >= start[:, None]) & (t_idx < (start + width)[:, None])
        keep &= ~stripe[:, :, None]
    for _ in range(num_f_masks):
        start, width = draw(f), draw(max_f + 1)
        stripe = (f_idx >= start[:, None]) & (f_idx < (start + width)[:, None])
        keep &= ~stripe[:, None, :]
    return torch.where(keep, feats, torch.zeros((), dtype=feats.dtype, device=dev))
