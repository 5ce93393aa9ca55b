"""Model FLOPs of the `u2pp_conformer` configuration (WeNet's U2++, a
multiply-add is two), from the configuration's widths and a step's shapes:
the forward of every row of one training step, times three (forward and
backward). No recompute is counted; the front end's features are not model
work.

- the encoder as `online_rnnt`'s (`flops/online_rnnt.py`'s arithmetic, here
  with this configuration's FFN and kernel widths): the attention over the
  unmasked (query, key) pairs of the step's draw;
- the CTC head over every frame;
- each decoder (left-to-right and right-to-left) over the u1 = labels + 1
  target positions: per layer the self-attention's projections and its
  causal pairs, the cross-attention's query and output projections, its key
  and value projections of every encoder frame and its (target, frame)
  pairs, the ReLU FFN; the output layer over the vocabulary.
"""

from __future__ import annotations


def _dims(config: dict) -> dict:
    m = config["model"]
    e, d = m["encoder"], m["att_decoder"]
    return {"d": e["output_size"], "f": e["linear_units"], "k": e["cnn_module_kernel"],
            "blocks": e["num_blocks"], "mel": e["input_size"], "v": m["vocab_size"],
            "dec_f": d["ffn"], "dec_blocks": d["blocks"] + d["r_blocks"]}


def subsample(x: dict, frames: int) -> float:
    t1, f1 = (frames - 3) // 2 + 1, (x["mel"] - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    d = x["d"]
    return 18 * t1 * f1 * d + 18 * t2 * f2 * d * d + 2 * t2 * f2 * d * d


def blocks(x: dict, rows_frames: int, pairs: int, pos_rows: int) -> float:
    d, f, k = x["d"], x["f"], x["k"]
    return x["blocks"] * (8 * rows_frames * d * f + 14 * rows_frames * d * d
                          + 2 * rows_frames * d * k + 6 * d * pairs + 2 * pos_rows * d * d)


def decoder_layer(x: dict, l: int, t: int) -> float:
    """One decoder layer of one row: l target positions over t frames."""
    d = x["d"]
    causal = l * (l + 1) // 2
    return (8 * l * d * d + 4 * d * causal  # self-attention
            + 4 * l * d * d + 4 * t * d * d + 4 * d * l * t  # cross-attention
            + 4 * l * d * x["dec_f"])  # FFN


def train_step(config: dict, c: dict) -> float:
    """c: b rows, frames a row, t_enc encoder frames, u1 target positions,
    pairs (the step's attended encoder pairs over all rows)."""
    x = _dims(config)
    b, t, l = c["b"], c["t_enc"], c["u1"]
    fwd = (b * subsample(x, c["frames"]) + blocks(x, b * t, c["pairs"], t)
           + b * t * 2 * x["d"] * x["v"]
           + b * x["dec_blocks"] * decoder_layer(x, l, t) + 2 * b * l * 2 * x["d"] * x["v"])
    return 3.0 * fwd
