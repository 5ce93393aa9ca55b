"""Host milliseconds a training step's call takes to return (the step is
dispatched; the device runs on), the mean over the window's steps: the
benchmark's own span around each call."""


def read(r: dict):
    d = r.get("dispatch_s")
    if not d or r.get("unit") != "step":
        return None
    return 1e3 * sum(d) / len(d)
