"""The least time the bytes of one conversion take at the chip's
bandwidth (``counts/convert.py``), as a share of the median device time
of the traced conversions."""
import statistics

from portbench.counts.convert import convert_bytes


def read(ctx):
    if not ctx.convert_device_ms:
        return None
    g = ctx.config["graph"]
    least_s = convert_bytes(g["n_nodes"], g["n_edges"]) / \
        ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (statistics.median(ctx.convert_device_ms) * 1e-3)
