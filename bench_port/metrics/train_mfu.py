"""The window's share of the card's peak: the least time one H100 could
take for the model work the window did (each step's, and each eval's, by
the family's count in ``work/<model>.py``) over the window's length.  Only a run on the card has one."""


def read(ctx):
    if not ctx.on_card or ctx.window_s <= 0 or not ctx.steps or not ctx.step_bounds:
        return None
    per_step = sum(ctx.step_bounds) / len(ctx.step_bounds)
    least = ctx.steps * per_step + ctx.evals * ctx.eval_bound
    return 100.0 * least / ctx.window_s
