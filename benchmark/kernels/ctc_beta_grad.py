"""Kernel #7, the CTC beta sweep and gradient (`ctc_beta_grad` entry): 19
flops a lattice cell on the fp32 peak; the state log-probs and alpha read
once, the gradient written once."""

EVENTS = ("ctc_beta_grad_warp_kernel", "ctc_beta_grad_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "s": 2 * (c["u1"] - 1) + 1}


def ops(s: dict) -> float:
    return 19 * s["b"] * s["t"] * s["s"]


def nbytes(s: dict) -> float:
    return 3 * 4 * s["b"] * s["t"] * s["s"]


def bound_s(s: dict, peaks: dict) -> float:
    return max(ops(s) / peaks["float32"], nbytes(s) / peaks["hbm"])
