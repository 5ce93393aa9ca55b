"""Kernel #5, the fused joint backward (`rnnt_fused_bwd` entry: the row
side, the vocabulary side and the fixed-order sums): three products of
2 D V flops a cell (the logits again, dlogits . W^T, a^T . dlogits) in fp32
as three TF32 passes each; the projections, W, b, log-sum-exp and both
upstream gradients read once, the four gradients written once."""

EVENTS = ("rnnt_bwd_wsplit_kernel", "rnnt_bwd_rows_kernel", "rnnt_bwd_vocab_kernel",
          "rnnt_bwd_sum_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "u1": c["u1"], "d": c["join"], "v": c["v"]}


def ops(s: dict) -> float:
    return 3 * 2 * s["b"] * s["t"] * s["u1"] * s["d"] * s["v"]


def nbytes(s: dict) -> float:
    b, t, u1, d, v = s["b"], s["t"], s["u1"], s["d"], s["v"]
    return 4 * (2 * (b * t * d + b * u1 * d + d * v + v) + b * (u1 - 1) + 3 * b * t * u1)


def bound_s(s: dict, peaks: dict) -> float:
    return max(3 * ops(s) / peaks["tf32"], nbytes(s) / peaks["hbm"])
