"""Rate of the host's copy of each batch into page-locked memory: the
bytes of the program's ``pin`` spans (``Trainer._h2d_async``, on the
prefetch thread, inside its ``h2d``) over their seconds (GB = 1e9 bytes).
The program pins only where it copies to a CUDA device."""


def read(ctx):
    s = ctx.phases.get("pin")
    if not s or not s.get("bytes") or s["seconds"] <= 0:
        return None
    return s["bytes"] / s["seconds"] / 1e9
