"""Kernel #6, the CTC alpha sweep (`ctc_alpha` entry, warp or block route):
13 flops a lattice cell (a three-term log-add and the emission) on the
fp32 peak; the state log-probs read once, alpha written once."""

EVENTS = ("ctc_alpha_warp_kernel", "ctc_alpha_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "s": 2 * (c["u1"] - 1) + 1}


def ops(s: dict) -> float:
    return 13 * s["b"] * s["t"] * s["s"]


def nbytes(s: dict) -> float:
    return 2 * 4 * s["b"] * s["t"] * s["s"]


def bound_s(s: dict, peaks: dict) -> float:
    return max(ops(s) / peaks["float32"], nbytes(s) / peaks["hbm"])
