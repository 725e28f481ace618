"""Share of its roofline the sparse step reaches: the least time of a
padded-COO step from the bytes its inputs need (``work/sparse_lr.py``:
each entry, y and mask once, each touched weight gathered and written
once), over the mean device time, a step, of every kernel that starts
inside the program's ``compute`` spans (the library's gathers, elementwise
kernels and ``index_add_``)."""


def read(ctx):
    if not ctx.events or not ctx.spans:
        return None
    from bench_port.trace import inside  # noqa: PLC0415

    steps = sum(1 for n, _, _ in ctx.spans if n == "compute")
    kernels = [e for e in inside(ctx.events, ctx.spans, "compute") if e.kind == "kernel"]
    seconds = sum(e.end - e.start for e in kernels)
    if not steps or seconds <= 0:
        return None
    return 100.0 * (sum(ctx.step_bounds) / len(ctx.step_bounds)) / (seconds / steps)
