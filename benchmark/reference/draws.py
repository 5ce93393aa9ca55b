"""A training step's random draws, worked out again from (seed, step).

The trainer under test seeds its generators a step from (seed, step) (the
arithmetic below is a frozen copy of its published constants): a CPU
generator for the dynamic-chunk draw, two host integers; a generator on the
card for every dropout keep-mask, drawn in the forward's order; and, where
SpecAugment is on, one on the card for its stripes. The
reference draws the same masks with the same calls, in the same order and
shapes, from a generator seeded alike, so its dropout is the step's.

The encoder's order: the positional dropout of the scaled embedding
[B, T, D]; per block the macaron FFN's inner [B*T, H] and residual
[B*T, D] masks, the attention probabilities' [B, H, T, T] where the
configuration drops them, the attention and conv residuals [B, T, D] each,
the second FFN's two masks. Then the heads' (`transducer_masks`,
`aed_masks`).
"""

from __future__ import annotations

import torch

_MASK63 = (1 << 63) - 1


def step_base(seed: int, step: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9) & _MASK63


def chunk_generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(step_base(seed, step))


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (step_base(seed, step) ^ 0x94D049BB133111EB) & _MASK63)


def specaug_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (step_base(seed, step) ^ 0x2545F4914F6CDD1D) & _MASK63)


def specaug_keep(gen: torch.Generator, feat_lens, t: int, f: int, sa: dict,
                 device) -> torch.Tensor:
    """[B, T, F] False on SpecAugment's stripes: per row `num_t_masks` time
    stripes (a start below the row's last frame, a width of 0-`max_t`
    frames), then `num_f_masks` frequency stripes (a start below F, a width
    of 0-`max_f` bins), each draw one integer a row."""
    b = feat_lens.shape[0]
    draw = lambda hi: torch.randint(0, hi, (b,), generator=gen, device=device)
    ti = torch.arange(t, device=device)[None, :]
    fi = torch.arange(f, device=device)[None, :]
    last = (feat_lens.to(device).long() - 1).clamp(min=0)
    keep = torch.ones((b, t, f), dtype=torch.bool, device=device)
    for _ in range(sa["num_t_masks"]):
        start = torch.minimum(draw(max(t, 1)), last)
        width = draw(sa["max_t"] + 1)
        keep &= ~((ti >= start[:, None]) & (ti < (start + width)[:, None]))[:, :, None]
    for _ in range(sa["num_f_masks"]):
        start, width = draw(f), draw(sa["max_f"] + 1)
        keep &= ~((fi >= start[:, None]) & (fi < (start + width)[:, None]))[:, None, :]
    return keep


def chunk_draw(seed: int, step: int, t: int, max_chunk: int) -> tuple[int, int]:
    """(chunk size, left chunks) of the step's dynamic-chunk mask over t
    encoder frames: c ~ U[1, max(t, 2)); full context when c > t // 2, else
    c % max_chunk + 1 frames a chunk; every left chunk (-1)."""
    gen = chunk_generator(seed, step)
    c = int(torch.randint(1, max(t, 2), (), generator=gen))
    int(torch.randint(0, 1 << 30, (), generator=gen))  # the left-chunk budget, unused
    return (t if c > t // 2 else c % max_chunk + 1), -1


def chunk_mask(t: int, chunk: int, left: int, device) -> torch.Tensor:
    """[t, t] True where query i may see key j."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    blk = i // max(chunk, 1)
    end = (blk + 1) * chunk
    start = torch.zeros_like(blk) if left < 0 else torch.clamp((blk - left) * chunk, min=0)
    return (j >= start) & (j < end)


def keep(gen: torch.Generator, shape, rate: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) >= rate


def conformer_masks(gen: torch.Generator, b: int, t: int, enc: dict, device) -> dict:
    """The encoder's keep-masks, in the step's order; an FFN's as [B, T, F]
    views of its [B*T, F] draw. With attention dropout a block also draws
    its attention probabilities' mask [B, H, T, T] before the attention's
    residual."""
    d, f, rate = enc["output_size"], enc["linear_units"], enc["dropout_rate"]
    att = enc.get("attention_dropout_rate", 0.0)
    k = lambda shape, r=rate: keep(gen, shape, r, device)
    m = {"pos": k((b, t, d)), "blocks": []}
    for _ in range(enc["num_blocks"]):
        blk = {"mac1": k((b * t, f)).view(b, t, f), "mac2": k((b * t, d)).view(b, t, d)}
        if att > 0:
            blk["attp"] = k((b, enc["attention_heads"], t, t), att)
        blk.update(att=k((b, t, d)), conv=k((b, t, d)), ff1=k((b * t, f)).view(b, t, f),
                   ff2=k((b * t, d)).view(b, t, d))
        m["blocks"].append(blk)
    return m


def transducer_masks(gen: torch.Generator, b: int, t: int, model: dict, device) -> dict:
    """The conformer transducer's: the encoder's, then the CTC head's input."""
    m = conformer_masks(gen, b, t, model["encoder"], device)
    m["ctc"] = keep(gen, (b, t, model["encoder"]["output_size"]),
                    model["ctc_dropout_rate"], device)
    return m


def aed_masks(gen: torch.Generator, b: int, t: int, l: int, model: dict, device) -> dict:
    """The hybrid CTC / attention model's: the encoder's, then each decoder's
    (the embedding [B, L, D]; per layer the self- and cross-attention
    residuals, the FFN's inner [B, L, F] and its residual), left-to-right
    first."""
    m = conformer_masks(gen, b, t, model["encoder"], device)
    enc, dec = model["encoder"], model["att_decoder"]
    d, rate = enc["output_size"], enc["dropout_rate"]

    def one(blocks):
        out = [keep(gen, (b, l, d), rate, device)]
        for _ in range(blocks):
            out += [keep(gen, (b, l, d), rate, device), keep(gen, (b, l, d), rate, device),
                    keep(gen, (b, l, dec["ffn"]), rate, device),
                    keep(gen, (b, l, d), rate, device)]
        return out

    m["decoder"] = one(dec["blocks"])
    if dec["r_blocks"] > 0 and dec["reverse_weight"] > 0:
        m["r_decoder"] = one(dec["r_blocks"])
    return m
