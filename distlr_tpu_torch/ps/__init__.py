"""The parameter-server stack of the port: the native KV server group and
its ctypes client (see :mod:`distlr_tpu_torch.ps.client`)."""

from distlr_tpu_torch.ps.client import STATS_FIELDS, KVWorker, PSTimeoutError  # noqa: F401
from distlr_tpu_torch.ps.server import ServerGroup  # noqa: F401
