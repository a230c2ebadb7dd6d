def read(ctx):
    return ctx.clips / ctx.window_s if ctx.clips and ctx.window_s else None
