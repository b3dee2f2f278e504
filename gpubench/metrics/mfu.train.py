"""``mfu.train``: the training step's share of the card's peak, in %.

The traced run's own steps/s (its window, outside the profiled slice)
times the FLOPs a step requires (the configuration's reference:
``flops_per_step``, for nsgan-mlp ``roofline.chunk_flops_per_step``,
632.4 MFLOP at z 20 and B 100), over the peak of the configuration's precision
(float32: 67e12 FLOP/s; the port's float32 paths forbid TF32)."""

from harness import roofline


def read(r):
    rate = r.values.get("train_steps_per_s")
    flops = getattr(r.cell.reference, "flops_per_step", None)
    if rate is None or flops is None or r.trace is None:
        return None
    peak = (roofline.BF16_FLOP_PER_S if r.conf.get("dtype") == "bfloat16"
            else roofline.FP32_FLOP_PER_S)
    return 100.0 * rate * flops(r.conf, r.conf["batch_size"]) / peak
