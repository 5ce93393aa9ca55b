"""Kernel #10, the fused FFN forward (`ffn_fwd` entry): 4 R D H flops for R
rows (both products), bf16 on the bf16 peak, fp32 as three TF32 passes at
the TF32 peak (3xTF32, the fastest products that keep fp32's accuracy: the
rule of every fp32 product here); the rows, both weights and the keep-masks
read once, the output written once."""

EVENTS = ("ffn_fwd_tc_kernel", "ffn_fwd_f32_kernel", "ffn_fwd_sum_kernel")


def shape(c: dict) -> dict:
    return {"rows": c["ffn_rows"], "d": c["d"], "h": c["ffn"], "dtype": c["dtype"],
            "masks": c["dropout"]}


def ops(s: dict) -> float:
    return 4 * s["rows"] * s["d"] * s["h"]


def nbytes(s: dict) -> float:
    e = 2 if s["dtype"] == "bfloat16" else 4
    r, d, h = s["rows"], s["d"], s["h"]
    return 2 * r * d * e + 2 * d * h * e + (r * (h + d) if s["masks"] else 0)


def bound_s(s: dict, peaks: dict) -> float:
    flop_s = (ops(s) / peaks["bfloat16"] if s["dtype"] == "bfloat16"
              else 3 * ops(s) / peaks["tf32"])
    return max(flop_s, nbytes(s) / peaks["hbm"])
