"""Share of the window the training loop waited for an epoch's first
batch: the program's ``epoch_fill`` spans (the ``data_load`` wait of
each epoch's first batch, where ``fit`` starts the prefetch pipeline anew
with nothing in flight) over the window's length.

The cut configurations have few batches an epoch, so the refill recurs
every few steps, where a deployment's epoch holds thousands.  A gain in
this metric alone is the cut's, not the deployment's."""


def read(ctx):
    s = ctx.phases.get("epoch_fill")
    if not s or ctx.window_s <= 0:
        return None
    return 100.0 * s["seconds"] / ctx.window_s
