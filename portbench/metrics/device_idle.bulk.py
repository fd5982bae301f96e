"""The share of the traced slice of the window in which no operation ran
on the device."""


def read(ctx):
    return ctx.idle_pct()
