"""Seconds from the start of the run to the window's start: imports, the
kernels' build, the inputs made, the set-up convert, the engine's warm-up
and capture."""


def read(ctx):
    return ctx.setup_s
