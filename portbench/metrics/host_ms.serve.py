def read(ctx):
    """Mean service time of the window's requests (started to answered)
    minus the device time a traced request keeps the card busy: the host's
    part of a request."""
    t = ctx.trace
    if t is None or not ctx.service or not ctx.traced_units:
        return None
    return 1e3 * (sum(ctx.service) / len(ctx.service) - t["busy_s"] / ctx.traced_units)
