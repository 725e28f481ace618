"""Share of the window the training loop waited for a batch's copy to the
card once its step had begun: the program's ``copy_wait`` spans (the part
of a ``compute`` span before the batch's ``h2d_copy``, timed on the card,
ended) over the window's length.  The copy that the producer's next pin
does not hide.  Where the program times copies but no step waited for
one, 0; where it times none (off the card), nothing."""


def read(ctx):
    s = ctx.phases.get("copy_wait")
    if ctx.window_s <= 0 or (not s and "h2d_copy" not in ctx.phases):
        return None
    return 100.0 * (s["seconds"] if s else 0.0) / ctx.window_s
