"""Device selection: the port's counterpart of ``distlr_tpu/utils/backend.py``.

Entry points run on the card unless the caller asks for the CPU.  A
missing card is an error that names the way out; nothing falls back to
the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device = "cuda") -> torch.device:
    """``requested`` as a :class:`torch.device`: ``"cuda"`` (the default,
    the current card), ``"cuda:N"`` or ``"cpu"``.  Raises when a CUDA
    device is asked for and none is usable."""
    dev = torch.device(requested)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda, cuda:N or cpu, got {requested!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(requested)!r} requested but CUDA is not available; "
            'pass device="cpu" (CLI: --device cpu) to run on the CPU')
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {dev} requested but only {torch.cuda.device_count()} CUDA device(s) exist")
    return dev
