"""``host_waits.train``: the calls a chunk of ``Trainer.train`` makes that
synchronize the host with the card, a chunk: the program's counter
``chunk.syncs`` (``generative_models_tpu_torch/utils/spans.py``), which
torch's sync debug mode fills inside each ``trainer.chunk`` while the
traced run's profiler records, over the number of those chunks. A mean
over every profiled chunk: a wait that only the chunks crossing two
epochs make still counts. Nothing off the card or from a program
without the counter."""


def read(r):
    if r.trace is None:
        return None
    try:
        from generative_models_tpu_torch.utils import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    found = snap.get("counters", {}).get("chunk.syncs")
    chunks = snap.get("aggregates", {}).get("trainer.chunk", {}).get("count")
    if found is None or not chunks:
        return None
    return found / chunks
