"""Model FLOPs of the `online_rnnt` configuration (a multiply-add is two),
from the configuration's widths and a unit's shapes. No recompute and no
padding of the attention beyond the step's masks is counted; the front
end's features are not model work.

- `train_step`: the forward of every row of one training step, times three
  (forward and backward): Conv2dSubsampling4, the blocks (the attention's
  scores and a.v over the unmasked (query, key) pairs that the step's own
  dynamic-chunk draw and padding leave), the LSTM predictor over the padded
  labels, the joint's projections and its output over every (frame, label)
  cell, the CTC head.
- `stream_call`: one `process_chunk` call: the chunk encoder over every row
  the call ran (all streams of the wave, in lockstep), each chunk frame
  seeing the keys of the valid cache and its chunk, the joint's encoder
  projection of every row, and, once per frame of an active stream and once
  per emitted token, a predictor step, its projection and the joint's
  output.
"""

from __future__ import annotations


def _dims(config: dict) -> dict:
    m = config["model"]
    e, p, j = m["encoder"], m["predictor"], m["joint"]
    return {"d": e["output_size"], "f": e["linear_units"], "k": e["cnn_module_kernel"],
            "blocks": e["num_blocks"], "mel": e["input_size"], "v": m["vocab_size"],
            "emb": p["embed_size"], "ph": p["hidden_size"], "po": p["output_size"],
            "dj": j["join_dim"]}


def subsample(x: dict, frames: int) -> float:
    """Two 3x3 stride-2 convs and the output linear over `frames` feature
    frames of one row."""
    t1, f1 = (frames - 3) // 2 + 1, (x["mel"] - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    d = x["d"]
    return 18 * t1 * f1 * d + 18 * t2 * f2 * d * d + 2 * t2 * f2 * d * d


def blocks(x: dict, rows_frames: int, pairs: int, pos_rows: int) -> float:
    """The conformer blocks over `rows_frames` query frames in all with
    `pairs` attended (query, key) pairs, the batch-shared positional
    projection over `pos_rows` positions."""
    d, f, k = x["d"], x["f"], x["k"]
    per = (8 * rows_frames * d * f + 14 * rows_frames * d * d + 2 * rows_frames * d * k
           + 6 * d * pairs + 2 * pos_rows * d * d)
    return x["blocks"] * per


def decision(x: dict) -> float:
    """One predictor step, its projection into the joint and the output."""
    return (2 * x["emb"] * 4 * x["ph"] + 2 * x["ph"] * 4 * x["ph"] + 2 * x["ph"] * x["po"]
            + 2 * x["po"] * x["dj"] + 2 * x["dj"] * x["v"])


def train_step(config: dict, c: dict) -> float:
    """c: b rows, frames a row, t_enc encoder frames, u1 label positions,
    pairs (the step's attended pairs over all rows)."""
    x = _dims(config)
    b, t, u1 = c["b"], c["t_enc"], c["u1"]
    fwd = (b * subsample(x, c["frames"]) + blocks(x, b * t, c["pairs"], t)
           + b * u1 * (2 * x["emb"] * 4 * x["ph"] + 2 * x["ph"] * 4 * x["ph"]
                       + 2 * x["ph"] * x["po"] + 2 * x["po"] * x["dj"])
           + b * t * 2 * x["d"] * x["dj"] + b * t * u1 * 2 * x["dj"] * x["v"]
           + b * t * 2 * x["d"] * x["v"])
    return 3.0 * fwd


def stream_call(config: dict, c: dict) -> float:
    """c: rows (streams encoded), chunk frames, window feature frames, keys
    (valid cache + chunk), decisions (active stream-frames + tokens)."""
    x = _dims(config)
    rows, ch = c["rows"], c["chunk"]
    return (rows * subsample(x, c["window"]) + blocks(x, rows * ch, rows * ch * c["keys"],
                                                      c["keys"])
            + rows * ch * 2 * x["d"] * x["dj"] + c["decisions"] * decision(x))
