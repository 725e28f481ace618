"""Share of the window in which no kernel, copy or set ran on the card:
one less the union of all device operations on any stream over the
window's length."""


def read(ctx):
    if not ctx.events or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
