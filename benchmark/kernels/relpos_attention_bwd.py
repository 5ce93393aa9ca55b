"""Kernel #3, the rel-pos attention backward (`relpos_attention_bwd` entry,
query side, key side and, in fp32, the fixed-order sum): 14 dk flops a head
and attended pair (the scores again, dv, da, dq, dk, dp), bf16 at the bf16
peak, fp32 as three TF32 passes; q, k, v, p, the output's gradient, the
saved fp32 output, log-sum-exp and mask read once, dq, dk, dv and dp
written once."""

EVENTS = ("relpos_bwd_q_tc_kernel", "relpos_bwd_kv_tc_kernel", "relpos_bwd_q_tf32_kernel",
          "relpos_bwd_kv_tf32_kernel", "relpos_bwd_sum_kernel")


def shape(c: dict) -> dict:
    return {"b": c["b"], "t": c["t_enc"], "d": c["d"], "pairs": c["pairs"],
            "heads": c["heads"], "dtype": c["dtype"]}


def ops(s: dict) -> float:
    return 14 * s["d"] * s["pairs"]


def nbytes(s: dict) -> float:
    e = 2 if s["dtype"] == "bfloat16" else 4
    b, t, d = s["b"], s["t"], s["d"]
    reads = 4 * b * t * d * e + t * d * e + b * t * d * 4 + b * s["heads"] * t * 4 + b * t * t
    writes = 3 * b * t * d * e + t * d * 4
    return reads + writes


def bound_s(s: dict, peaks: dict) -> float:
    flop_s = (ops(s) / peaks["bfloat16"] if s["dtype"] == "bfloat16"
              else 3 * ops(s) / peaks["tf32"])
    return max(flop_s, nbytes(s) / peaks["hbm"])
