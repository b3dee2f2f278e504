"""``trainer_host_ms.train``: the host's own time a chunk of
``Trainer.train``, in ms: each ``trainer.chunk`` span's duration less
the time its ``.wait`` spans cover (the host blocked on the card), from
the program's spans (``generative_models_tpu_torch/utils/spans.py``),
which record while the traced run's profiler does. The chunks go in
slices of the traffic's ``trace_chunks``, in the order the harness
profiled them; the reading is the least of the slices' medians, as the
profiler's own host work only adds to a span and its slice that records
the host's operations adds the most. Nothing off the card or from a
program without the spans."""

import statistics


def read(r):
    if r.trace is None:
        return None
    try:
        from generative_models_tpu_torch.utils import spans
    except ImportError:
        return None
    k = r.traffic["trace_chunks"]
    per = [((root.end_ns - root.start_ns) - spans.wait_ns(members)) / 1e6
           for root, members in spans.requests(spans.snapshot(),
                                               "trainer.chunk")]
    if len(per) < k:
        return None
    return min(statistics.median(per[i:i + k])
               for i in range(0, len(per) - k + 1, k))
