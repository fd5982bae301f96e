"""The median, over the traced requests, of the least time the bytes its
preprocessing must move take at the chip's bandwidth
(``counts/preprocess.py``), as a share of the device time it took."""
import statistics


def read(ctx):
    times = ctx.lanes["preprocess"]
    if not times:
        return None
    bw = ctx.peaks["hbm_bytes_per_s"]
    return statistics.median(
        100.0 * s["bytes"] / bw / (t * 1e-3)
        for s, t in zip(ctx.sizes, times))
