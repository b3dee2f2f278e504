"""``chunk_roofline.train``: the chunk kernel's share of its roofline, in
%: the least time a chunk of ``scan_steps`` steps could take
(``roofline.chunk_bound``, frozen; nsgan-mlp at B 100: operations-bound,
9.439 us a step) times the launches, over the device time of the
``gan_chunk_kernel`` events of the profiled slice. Nothing where the
kernel did not run or the profiler kept fewer events than the launches
the program counted."""

KERNEL = "gan_chunk_kernel"


def read(r):
    bound = getattr(r.cell.reference, "chunk_bound_s", None)
    k = None if r.trace is None else r.trace.kernel(KERNEL)
    if bound is None or k is None:
        return None
    events, seconds = k
    launches = r.trace.launched.get("gan_chunk", 0)
    if launches < 1 or events != launches or seconds <= 0:
        return None
    per_launch = bound(r.conf, r.conf["batch_size"], r.conf["scan_steps"])
    return 100.0 * launches * per_launch / seconds
