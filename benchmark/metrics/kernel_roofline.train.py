"""The hand kernels' share of their rooflines in the traced training steps:
the sum of each launch's bound (`benchmark/kernels/<entry>.py`) over the
sum of those kernels' device time in the trace, in %."""


def read(r: dict):
    k = r.get("kernels")
    if not k or r.get("unit") != "step" or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
