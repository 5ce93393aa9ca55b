"""The training cells' comparison: the reference follows the program's first
three steps from the same weights, batches and draws, and three numbers are
read from both sides.

- `loss`: each step's loss, |program - reference| / |reference|, the worst
  of the three steps;
- `grad`: the first step's clipped gradient as the optimizer got it (the
  program's worked out from its first moment after one step: mu / (1 - b1)
  - decay * p0), per leaf the gap between the two sides' norms over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  the worst leaf;
- `change`: the parameters' change after three steps, the same measure,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding, as a key's
  bias under softmax, moves by round-off alone).

The reference runs in blocks of rows, each block's loss divided by the
whole batch's rows, so that the blocks' gradients sum to the step's.
"""

from __future__ import annotations

import torch

from benchmark.reference import aed, draws, transducer
from benchmark.reference.adam import Adam
from benchmark.reference.features import logmel
from benchmark.reference.precision import Precision, exact

STEPS = 3


def _model(cfg: dict):
    """(the loss, the step's keep-masks) of the configuration's model."""
    if cfg["model_class"] == "transducer":
        return transducer.train_loss, lambda gen, b, t, l, dev: draws.transducer_masks(
            gen, b, t, cfg["model"], dev)
    if cfg["model_class"] == "aed":
        return aed.train_loss, lambda gen, b, t, l, dev: draws.aed_masks(
            gen, b, t, l, cfg["model"], dev)
    raise ValueError(f"model_class {cfg['model_class']!r}: no reference")


def _rows(masks, r0: int, r1: int):
    """Every mask cut to the rows r0:r1."""
    if isinstance(masks, dict):
        return {k: _rows(v, r0, r1) for k, v in masks.items()}
    if isinstance(masks, list):
        return [_rows(v, r0, r1) for v in masks]
    return masks[r0:r1]


def follow(cfg: dict, weights: dict, batches: list, seed: int, prec: Precision,
           rows: int = 32) -> dict:
    """The reference's first three steps from `weights` (copied) ->
    {"loss": [3], "grad": {leaf: first clipped gradient},
     "change": {leaf: p3 - p0}}, TF32 off."""
    with exact():
        return _follow(cfg, weights, batches, seed, prec, rows)


def _follow(cfg, weights, batches, seed, prec, rows):
    enc = cfg["model"]["encoder"]
    train_loss, step_masks = _model(cfg)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(cfg["optim"], params)
    out = {"loss": []}
    for step in range(STEPS):
        batch = batches[step]
        waves, wave_lens = batch["waves"], batch["wave_lens"]
        b = waves.shape[0]
        feats = logmel(waves, cfg["feature"], prec)
        flens = 1 + wave_lens.long() // cfg["feature"]["hop_length"]
        sa = cfg.get("specaug", {})
        if sa.get("enabled"):
            keep = draws.specaug_keep(draws.specaug_generator(seed, step, waves.device), flens,
                                      feats.shape[1], feats.shape[2], sa, waves.device)
            feats = torch.where(keep, feats, torch.zeros((), device=feats.device))
        t = ((feats.shape[1] - 1) // 2 - 1) // 2
        chunk, left = draws.chunk_draw(seed, step, t, enc["max_chunk_size"])
        masks = step_masks(draws.dropout_generator(seed, step, waves.device), b, t,
                           batch["texts"].shape[1] + 1, waves.device)
        for p in params.values():
            p.grad = None
        total = 0.0
        for r0 in range(0, b, rows):
            r1 = min(b, r0 + rows)
            loss, _, _ = train_loss(params, cfg, feats[r0:r1], flens[r0:r1],
                                    batch["texts"][r0:r1], batch["text_lens"][r0:r1], chunk,
                                    left, _rows(masks, r0, r1), prec, b)
            loss.backward()
            total += float(loss.detach())
        del masks
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if step == 0:
            out["grad"] = {k: g.detach().clone() for k, g in opt.clipped(grads).items()}
        opt.step({k: p.data for k, p in params.items()}, grads)
        out["loss"].append(total)
    out["change"] = {k: params[k].detach() - p0[k] for k in params}
    return out


def program_side(losses, mu1, p3, p0: dict, optim: dict) -> dict:
    """The program's readings in `follow`'s form: its three losses, its first
    clipped gradient from the first moment after step one (flat, in `p0`'s
    order) and its change after step three (p3 flat)."""
    b1 = optim["betas"][0]
    out = {"loss": [float(x) for x in losses], "grad": {}, "change": {}}
    i = 0
    for k, p in p0.items():
        n = p.numel()
        u = mu1[i:i + n].view_as(p) / (1.0 - b1)
        out["grad"][k] = u - optim["weight_decay"] * p
        out["change"][k] = p3[i:i + n].view_as(p) - p
        i += n
    if i != mu1.numel() or i != p3.numel():
        raise ValueError(f"the program's flat state holds {mu1.numel()} values, the "
                         f"weights {i}")
    return out


def leaf_gaps(side: dict, ref: dict, leaves) -> dict:
    """{leaf: |side's norm - ref's norm| / max(ref's norm, the median leaf's)}."""
    norms = {k: float(ref[k].double().norm()) for k in leaves}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(side[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in leaves}


def moved(ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    gnorm = {k: float(g.double().norm()) for k, g in ref["grad"].items()}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    return [k for k in gnorm if gnorm[k] >= 1e-3 * med]


def compare(side: dict, ref: dict) -> dict:
    """-> {"loss", "grad", "change"}: `side` (the program's or a control's
    readings) against the fp32 reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(side["loss"], ref["loss"]))
    return {"loss": loss,
            "grad": max(leaf_gaps(side["grad"], ref["grad"], list(ref["grad"])).values()),
            "change": max(leaf_gaps(side["change"], ref["change"], moved(ref)).values())}
