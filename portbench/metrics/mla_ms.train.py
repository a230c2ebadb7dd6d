from portbench import layer_spans


def read(ctx):
    return layer_spans.per_step_ms(ctx, ["mla"])
