from portbench import flops


def read(ctx):
    """Model FLOP of the answered requests over the time spent serving them
    (started to answered, queueing left out) and the peak: at a fixed offered
    rate the window's length says nothing of the program's speed."""
    if not ctx.flops_done or not ctx.service:
        return None
    return 100.0 * ctx.flops_done / sum(ctx.service) / flops.PEAK_FLOPS
