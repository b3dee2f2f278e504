"""``linear_host_us.gen``: the host's time a launch of the MLP forward
kernel through ``ops/linear.py::fused_linear`` takes in the sampler, in
us: the ``linear.launch`` spans of the program
(``generative_models_tpu_torch/utils/spans.py``, recorded while the
traced run's profiler records) inside each ``trainer.sample`` request,
eight a reverse step. The requests go in slices of the traffic's
``trace_requests``, in the order the harness profiled them; the reading
is the least of the slices' medians over their launches, as the
profiler's own host work only adds to a span. Nothing off the card or
from a program without the spans."""

import statistics


def read(r):
    if r.trace is None:
        return None
    try:
        from generative_models_tpu_torch.utils import spans
    except ImportError:
        return None
    k = r.traffic["trace_requests"]
    per = [[(s.end_ns - s.start_ns) / 1e3 for s in members
            if s.name == "linear.launch"]
           for _, members in spans.requests(spans.snapshot(),
                                            "trainer.sample")]
    slices = [sum(per[i:i + k], []) for i in range(0, len(per) - k + 1, k)]
    slices = [s for s in slices if s]
    if not slices:
        return None
    return min(statistics.median(s) for s in slices)
