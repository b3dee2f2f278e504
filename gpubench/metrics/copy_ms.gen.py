"""``copy_ms.gen``: the copy of a request's images to the host, in ms:
the ``sample.copy`` span of each ``trainer.sample`` request of the
program (``generative_models_tpu_torch/utils/spans.py``, recorded while
the traced run's profiler records), which starts after ``sample.wait``
has waited for the request's queued work, so it holds the copy alone.
The requests go in slices of the traffic's ``trace_requests``, in the
order the harness profiled them; the reading is the least of the
slices' medians, as the profiler's own host work only adds to a span.
Nothing off the card or from a program without the spans."""

import statistics


def read(r):
    if r.trace is None:
        return None
    try:
        from generative_models_tpu_torch.utils import spans
    except ImportError:
        return None
    k = r.traffic["trace_requests"]
    per = [sum(copies) for copies in (
        [(s.end_ns - s.start_ns) / 1e6 for s in members
         if s.name == "sample.copy"]
        for _, members in spans.requests(spans.snapshot(), "trainer.sample"))
        if copies]
    if len(per) < k:
        return None
    return min(statistics.median(per[i:i + k])
               for i in range(0, len(per) - k + 1, k))
