"""Rate of the window's host-to-device copies on the card: the bytes of
every ``Memcpy HtoD`` in the device trace over the time the card spent on
them (GB = 1e9 bytes)."""


def read(ctx):
    if not ctx.events:
        return None
    copies = [e for e in ctx.events if e.kind == "memcpy" and "HtoD" in e.name]
    seconds = sum(e.end - e.start for e in copies)
    n_bytes = sum(e.bytes for e in copies)
    if seconds <= 0 or n_bytes <= 0:
        return None
    return n_bytes / seconds / 1e9
