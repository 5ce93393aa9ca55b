"""The hand kernels' share of their rooflines in the traced streaming calls
(#1 "highest" and #10 fp32): the sum of each launch's bound over the sum of
those kernels' device time, in %."""


def read(r: dict):
    k = r.get("kernels")
    if not k or r.get("unit") != "chunk" or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
