"""The window's seconds over the conversions completed in it, each
synchronised at its end."""


def read(ctx):
    w = ctx.window
    if ctx.kind != "convert" or not w.converts:
        return None
    return 1e3 * w.convert_s / w.converts
