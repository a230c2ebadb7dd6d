from portbench.metrics import _shared


def read(ctx):
    return _shared.mfu_pct(ctx)
