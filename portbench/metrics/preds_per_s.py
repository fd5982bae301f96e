"""Predictions answered in the window (the seeds of every request the
driver saw answered before the window closed), per second of the window."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    return sum(r.n_seeds for r in ctx.answered_in_window()) / ctx.seconds
