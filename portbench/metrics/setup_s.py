def read(ctx):
    return ctx.setup_s
