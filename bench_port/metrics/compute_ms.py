"""Device time of one training step: the kernels that start inside the
program's ``compute`` spans (the step's launches and the wait for the
card), summed from the device trace, over the number of steps.  The wait
for the batch's copy, which the span also holds, is not in it."""


def read(ctx):
    if not ctx.events or not ctx.spans:
        return None
    from bench_port.trace import inside  # noqa: PLC0415

    steps = sum(1 for n, _, _ in ctx.spans if n == "compute")
    kernels = [e for e in inside(ctx.events, ctx.spans, "compute") if e.kind == "kernel"]
    seconds = sum(e.end - e.start for e in kernels)
    if not steps or seconds <= 0:
        return None
    return 1e3 * seconds / steps
