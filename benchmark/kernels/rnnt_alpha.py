"""Kernel #8, the RNN-T alpha sweep (`rnnt_alpha` entry, warp or block
route): 10 flops a (frame, label) cell on the fp32 peak; blank and label
log-probs read once, alpha written once."""

EVENTS = ("rnnt_alpha_warp_kernel", "rnnt_alpha_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "u1": c["u1"]}


def ops(s: dict) -> float:
    return 10 * s["b"] * s["t"] * s["u1"]


def nbytes(s: dict) -> float:
    return 3 * 4 * s["b"] * s["t"] * s["u1"]


def bound_s(s: dict, peaks: dict) -> float:
    return max(ops(s) / peaks["float32"], nbytes(s) / peaks["hbm"])
