"""The routed experts' products of the traced steps (the rows the
program's counter gave each held expert, three products each, forward once
and backward twice) at the peak, over the device time inside
``smm.moe.experts``."""
from portbench import flops, flops_moonlight, layer_spans


def read(ctx):
    rows = getattr(ctx, "counted", None)
    ms = layer_spans.per_step_ms(ctx, ["moe.experts"])
    if rows is None or not ms:
        return None
    work = flops.TRAIN_FACTOR * flops_moonlight.expert_products(ctx.cfg, float(rows.sum()))
    return 100.0 * work / flops.PEAK_FLOPS / (ms / 1e3 * ctx.traced_units)
