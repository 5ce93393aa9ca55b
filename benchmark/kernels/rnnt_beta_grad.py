"""Kernel #9, the RNN-T beta sweep and gradients (`rnnt_beta_grad` entry):
20 flops a cell on the fp32 peak; blank, label and alpha read once, both
gradients written once."""

EVENTS = ("rnnt_beta_grad_warp_kernel", "rnnt_beta_grad_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "u1": c["u1"]}


def ops(s: dict) -> float:
    return 20 * s["b"] * s["t"] * s["u1"]


def nbytes(s: dict) -> float:
    return 5 * 4 * s["b"] * s["t"] * s["u1"]


def bound_s(s: dict, peaks: dict) -> float:
    return max(ops(s) / peaks["float32"], nbytes(s) / peaks["hbm"])
