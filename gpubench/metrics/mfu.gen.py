"""``mfu.gen``: generation's share of the card's peak, in %: the traced
run's own images/s (its window, outside the profiled slice) times the
FLOPs an image requires (the configuration's reference:
``flops_per_image``; for ddpm-mlp the row layers at every step and the
time path once a step, as every row of a step shares its t), over the
float32 peak, 67e12 FLOP/s."""

from harness import roofline


def read(r):
    rate = r.values.get("gen_images_per_s")
    flops = getattr(r.cell.reference, "flops_per_image", None)
    if rate is None or flops is None or r.trace is None:
        return None
    f = flops(r.conf, r.traffic["n"], r.traffic["sample_steps"])
    return 100.0 * rate * f / roofline.FP32_FLOP_PER_S
