"""The training steps' model FLOPs over the window (`benchmark/flops/<config>.py`,
forward times three) divided by the window's wall and the dense bf16 peak:
the whole step's share of the card's peak, in %."""


def read(r: dict):
    if not r.get("model_flops") or r.get("unit") != "step":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / r["peak_flops"]
