"""The streaming calls' model FLOPs over the window (`benchmark/flops/<config>.py`:
the chunk encoder over every row run, a predictor step and the joint per
frame of an active stream and per token) divided by the window's wall and
the dense TF32 peak, the fastest rate fp32 products could run, in %."""


def read(r: dict):
    if not r.get("model_flops") or r.get("unit") != "chunk":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / r["peak_flops"]
