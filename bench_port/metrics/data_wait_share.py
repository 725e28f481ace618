"""Share of the window the training loop waited for its next batch: the
program's ``data_load`` spans (``Trainer._run_epochs``: the wait on the
prefetch queue, which holds the slice, the pinning copy and the enqueue
of the host-to-device copy) over the window's length."""


def read(ctx):
    s = ctx.phases.get("data_load")
    if not s or ctx.window_s <= 0:
        return None
    return 100.0 * s["seconds"] / ctx.window_s
