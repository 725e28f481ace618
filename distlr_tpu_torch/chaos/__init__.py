"""Network chaos layer of the port: deterministic, seedable TCP fault
injection for the PS stack (delay and jitter, bandwidth throttling,
connection resets at op or byte offsets, timed full and partial
partitions, and SIGKILLs of server ranks), the proof harness of the
client's in-place retries and of the durable store's recovery.

:mod:`distlr_tpu_torch.chaos.plan` holds the JSON plan format and
:mod:`distlr_tpu_torch.chaos.proxy` the proxy; ``launch chaos`` wraps an
existing server group, ``ServerGroup(via_chaos=...)`` a spawned one.
"""

from distlr_tpu_torch.chaos.plan import (  # noqa: F401
    FAULT_KINDS,
    FaultPlan,
    FaultPlanError,
    FaultSpec,
    load_plan,
    parse_plan,
)
from distlr_tpu_torch.chaos.proxy import (  # noqa: F401
    EVENT_SCHEMA,
    ChaosFabric,
    ChaosLink,
    load_events_doc,
)
