"""The parameter-server stack of the port: the native KV server group and
its ctypes client (see :mod:`distlr_tpu_torch.ps.client`)."""

from distlr_tpu_torch.ps.client import (  # noqa: F401
    STATS_FIELDS,
    FaultRateTracker,
    KVNamespace,
    KVWorker,
    PSEpochError,
    PSRejectedError,
    PSTimeoutError,
    RetryPolicy,
    namespace_layout,
    parse_namespace_optimizers,
)
from distlr_tpu_torch.ps.membership import (  # noqa: F401
    MembershipCoordinator,
    MembershipServer,
    layout_client,
)
from distlr_tpu_torch.ps.server import ServerGroup, ServerSupervisor  # noqa: F401
