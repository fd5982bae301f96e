"""The 95th percentile (nearest rank), over every request due in the
window, of the time from when it was due to when the driver saw its
answer; a request never answered counts as answered at the end of the
wait past the window's close."""
from portbench.harness import percentile
from portbench.traffic import WAIT_S


def read(ctx):
    w = ctx.window
    if ctx.kind != "serve" or not w.records:
        return None
    never = w.t_end + WAIT_S
    lat = [(r.done if r.done is not None else never) - r.due
           for r in w.records]
    return 1e3 * percentile(lat, 0.95)
