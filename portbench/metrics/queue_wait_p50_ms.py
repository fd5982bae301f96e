"""The median, over the requests due in the window, of the time from when
each was due to when the engine seated it (its ``admit_t``)."""
import statistics


def read(ctx):
    if ctx.kind != "serve":
        return None
    waits = [r.handle.admit_t - r.due for r in ctx.window.records
             if r.handle is not None and r.handle.admit_t is not None]
    return 1e3 * statistics.median(waits) if waits else None
