"""Share of its roofline the dense gradient's hand kernels reach: the
least time of the step's gradient at its (B, D) and feature dtype
(``work/binary_lr.py``) over the mean device time, a step, of the
``ops.fused_lr`` kernels (``lr_*_kernel``) that start inside the
program's ``compute`` spans."""

import re

_HAND = re.compile(r"\blr_\w*_kernel\b")


def read(ctx):
    if not ctx.events or not ctx.spans:
        return None
    from bench_port.trace import inside  # noqa: PLC0415

    steps = sum(1 for n, _, _ in ctx.spans if n == "compute")
    kernels = [e for e in inside(ctx.events, ctx.spans, "compute")
               if e.kind == "kernel" and _HAND.search(e.name)]
    seconds = sum(e.end - e.start for e in kernels)
    if not steps or seconds <= 0:
        return None
    return 100.0 * (sum(ctx.step_bounds) / len(ctx.step_bounds)) / (seconds / steps)
