"""``device_idle.train``: the share of the profiled training slice in
which no kernel, copy or set ran on the card, in %, from a slice that
records the device's activity alone (``harness/trace.py``), so that the
profiler's own host work stays out of it (the Trainer's host work
between chunks shows here)."""


def read(r):
    t = r.trace
    if t is None or not t.complete or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
