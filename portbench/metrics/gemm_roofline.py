from portbench.metrics import _shared


def read(ctx):
    return _shared.roofline_pct(ctx, "linear", "gemm")
