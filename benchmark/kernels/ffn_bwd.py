"""Kernel #11, the fused FFN backward (`ffn_bwd` entry: row side, LN pass,
weight side): 10 R D H flops for R rows, bf16 on the bf16 peak, fp32 as
three TF32 passes at the TF32 peak (as #10); the rows, the output's
gradient, both weights and the masks read once, the rows' gradient and both
weights' gradients written once."""

EVENTS = ("ffn_bwd_rows_tc_kernel", "ffn_bwd_rows_f32_kernel", "ffn_bwd_ln_kernel",
          "ffn_bwd_w_kernel")


def shape(c: dict) -> dict:
    return {"rows": c["ffn_rows"], "d": c["d"], "h": c["ffn"], "dtype": c["dtype"],
            "masks": c["dropout"]}


def ops(s: dict) -> float:
    return 10 * s["rows"] * s["d"] * s["h"]


def nbytes(s: dict) -> float:
    e = 2 if s["dtype"] == "bfloat16" else 4
    r, d, h = s["rows"], s["d"], s["h"]
    return 3 * r * d * e + 2 * d * h * e + 2 * d * h * 4 + (r * (h + d) if s["masks"] else 0)


def bound_s(s: dict, peaks: dict) -> float:
    flop_s = (ops(s) / peaks["bfloat16"] if s["dtype"] == "bfloat16"
              else 3 * ops(s) / peaks["tf32"])
    return max(flop_s, nbytes(s) / peaks["hbm"])
