"""Kernel #4, the fused joint forward (`rnnt_fused_fwd` entry: W tiles and
the row kernel): one product of 2 D V flops a (frame, label) cell in fp32
as three TF32 passes at the TF32 peak; the projections, W and b read once,
blank, label and log-sum-exp written once."""

EVENTS = ("rnnt_fwd_wtile_kernel", "rnnt_fwd_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "u1": c["u1"], "d": c["join"], "v": c["v"]}


def ops(s: dict) -> float:
    return 2 * s["b"] * s["t"] * s["u1"] * s["d"] * s["v"]


def nbytes(s: dict) -> float:
    b, t, u1, d, v = s["b"], s["t"], s["u1"], s["d"], s["v"]
    return 4 * (b * t * d + b * u1 * d + d * v + v + b * (u1 - 1) + 3 * b * t * u1)


def bound_s(s: dict, peaks: dict) -> float:
    return max(3 * ops(s) / peaks["tf32"], nbytes(s) / peaks["hbm"])
