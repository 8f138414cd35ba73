"""The whole round's share of the card's f32 peak while it works: the CNN's
model FLOPs for the samples trained in the measured window (involved
clients × H × batch, padding rows not counted; 3× the forward a sample)
over the seconds in which the card ran an operation in that window,
against 67 TFLOP/s (the configuration is f32, TF32 off). It bounds the
kernels' roofline shares of ``round_device_s``."""
from portbench.work.models import cnn_train_flops_per_sample
from portbench.work.peaks import PEAK_FLOPS


def read(ctx):
    busy = ctx.get("device_busy_s")
    if not busy:
        return None
    fl = ctx["traffic"]["fl"]
    samples = sum(r["involved"] for r in ctx["rows"]) * fl["local_steps"] * fl["local_batch"]
    flops = samples * cnn_train_flops_per_sample(ctx["config"])
    return 100.0 * flops / busy / PEAK_FLOPS["f32"]
