"""The share of the traced training window in which no kernel, copy or set
ran on the card (the union of the trace's device intervals), in %."""


def read(r: dict):
    t = r.get("trace")
    if not t or r.get("unit") != "step" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
