"""PyTorch/CUDA port of ``distlr_tpu`` for an NVIDIA H100.

Module names mirror ``distlr_tpu`` so each counterpart is easy to find.
The port imports ``torch`` and ``numpy`` and nothing of JAX or of the
``distlr_tpu`` package; where it needs a helper from there it keeps its
own copy.  Entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"`` / ``--device cpu``).
"""

__version__ = "0.1.0"

from distlr_tpu_torch.config import Config  # noqa: E402, F401
