"""``device_idle.gen``: the share of the profiled slice of whole
requests in which no kernel, copy or set ran on the card, in %, from a
slice that records the device's activity alone (``harness/trace.py``;
the host's enqueue of each reverse step and the copy to the host show
here)."""


def read(r):
    t = r.trace
    if t is None or not t.complete or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
