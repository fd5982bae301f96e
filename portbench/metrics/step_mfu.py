"""The forward's operations that the layer equations need on the live
subgraphs answered in the window, per second, as a share of the chip's
float32 peak: the mean count over the checked requests (from the live
sizes the reference computes, ``counts/model_<kind>.py``) times the
requests answered, over the window."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.sizes:
        return None
    per_request = sum(s["flops"] for s in ctx.sizes) / len(ctx.sizes)
    done = len(ctx.answered_in_window())
    return 100.0 * per_request * done / (
        ctx.seconds * ctx.peaks["float32_flops_per_s"])
