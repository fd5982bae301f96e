"""The window over the engine's steps in it (``ServeStats.steps``): one
cycle of admission, step and read-back."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.window.steps:
        return None
    return 1e3 * ctx.seconds / ctx.window.steps
