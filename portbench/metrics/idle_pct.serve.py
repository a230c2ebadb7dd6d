from portbench.metrics import _shared


def read(ctx):
    return _shared.idle_pct(ctx)
