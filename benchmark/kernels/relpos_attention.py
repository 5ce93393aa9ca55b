"""Kernel #2, the rel-pos attention forward (`relpos_attention` entry):
6 dk flops a head and attended (query, key) pair ((q+u).k, (q+v).p, a.v),
bf16 at the bf16 peak, fp32 as three TF32 passes at the TF32 peak; q, k,
v, p and the mask read once, the output, its fp32 copy and the log-sum-exp
written once."""

EVENTS = ("relpos_fwd_tc_kernel", "relpos_fwd_tf32_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "d": c["d"], "pairs": c["pairs"],
            "heads": c["heads"], "dtype": c["dtype"]}


def ops(s: dict) -> float:
    return 6 * s["d"] * s["pairs"]  # 6 dk a head and pair, over the heads


def nbytes(s: dict) -> float:
    e = 2 if s["dtype"] == "bfloat16" else 4
    b, t, d = s["b"], s["t"], s["d"]
    return 3 * b * t * d * e + t * d * e + b * t * t + b * t * d * (e + 4) + b * s["heads"] * t * 4


def bound_s(s: dict, peaks: dict) -> float:
    flop_s = (ops(s) / peaks["bfloat16"] if s["dtype"] == "bfloat16"
              else 3 * ops(s) / peaks["tf32"])
    return max(flop_s, nbytes(s) / peaks["hbm"])
