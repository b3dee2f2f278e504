"""``mlp_fwd_roofline.gen``: the MLP forward kernel's share of its
roofline over the profiled requests, in %: the sum of ``fwd_bound``
(``roofline``, frozen: each input read once, each output written once,
the FMAs at the float32 peak) over every ``mlp_fwd_kernel`` launch's
shape, over the sum of their device times.

The launches' shapes are those of the port's sampler on the repository's
MLP net (``models/ddpm_net.py``): each reverse step runs the net once
on all n rows, eight launches of one layer each, the time MLP's two
(td -> td), ``in`` (X -> H), ``t1`` (td -> H), ``mid`` (H -> H), ``t2``
(td -> H), ``out`` (H -> X) and ``skip`` (X -> X). Nothing where the
program's launch counter did not count exactly that many launches, or
the profiler kept fewer events."""

from harness import roofline

KERNEL = "mlp_fwd_kernel"


def launch_shapes(c, n):
    x, h, td = c["image_dim"], c["hidden_dim"], c["ddpm_time_dim"]
    return [([td, td], n), ([td, td], n), ([x, h], n), ([td, h], n),
            ([h, h], n), ([td, h], n), ([h, x], n), ([x, x], n)]


def read(r):
    k = None if r.trace is None else r.trace.kernel(KERNEL)
    if k is None or r.conf.get("arch", "mlp") != "mlp":
        return None
    events, seconds = k
    shapes = launch_shapes(r.conf, r.traffic["n"])
    steps, reqs = r.traffic["sample_steps"], r.traffic["trace_requests"]
    launches = len(shapes) * steps * reqs
    if r.trace.launched.get("mlp_fwd") != launches or events != launches:
        return None
    bound = sum(roofline.fwd_bound(d, b)[0] for d, b in shapes)
    return 100.0 * bound * steps * reqs / seconds
