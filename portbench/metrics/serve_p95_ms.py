from portbench.metrics import _shared


def read(ctx):
    return _shared.percentile_ms(ctx, 95)
