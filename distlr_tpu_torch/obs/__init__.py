"""Observability of the port: metrics registry, phase tracing, exporters.

Counterpart of ``distlr_tpu/obs/`` without its fleet tools (ROADMAP
A.21): one process-wide
:class:`MetricsRegistry` of labeled counters, gauges and histograms, under
the JAX package's series names and exposition text (the PS server group
and supervisor, the KV client, the trainers' step rate and staleness,
the scoring tier, the router and tenants, the feedback loop), a
:func:`trace_phase` span API whose per-phase breakdown says where a
step's host time went (Chrome trace-event dumps load in Perfetto),
exporters (Prometheus text and a JSON snapshot over a stdlib HTTP
endpoint, ``launch ... --metrics-port``; the endpoint file of a process
under ``--obs-run-dir``), the runtime probes of
:mod:`distlr_tpu_torch.obs.torchrt` (compiles by signature, device
bytes), and the distributed tracing of :mod:`distlr_tpu_torch.obs.dtrace`
(span journals, the flight recorder, ``launch trace-agg``).

Metric namespace, as in the JAX package:

* ``distlr_ps_server_*``  — ServerGroup/ServerSupervisor lifecycle
* ``distlr_ps_client_*``  — native KV client ops, latency, bytes
* ``distlr_train_*``      — step/sample counters, rates, staleness
* ``distlr_serve_*``, ``distlr_route_*``, ``distlr_tenant_*``,
  ``distlr_rollout_*`` — the scoring tier
* ``distlr_feedback_*``, ``distlr_online_*`` — the online loop
* ``distlr_phase_seconds``— per-phase histogram behind the tracer
* ``distlr_trace_*``      — distributed-trace span, journal and flight-
  recorder accounting (:mod:`distlr_tpu_torch.obs.dtrace`)
* ``distlr_jax_*``        — runtime introspection (the JAX names, read
  by name by fleet tools; :mod:`distlr_tpu_torch.obs.torchrt` says what
  each counts here)
"""

from distlr_tpu_torch.obs import dtrace  # noqa: F401
from distlr_tpu_torch.obs.exporters import (  # noqa: F401
    MetricsServer,
    endpoint_path,
    install_snapshot_atexit,
    snapshot_env_paths,
    start_metrics_server,
    write_endpoint,
    write_metrics_snapshot,
)
from distlr_tpu_torch.obs.registry import (  # noqa: F401
    COUNT_BUCKETS,
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    family_total,
    get_registry,
    percentile_from_counts,
)
from distlr_tpu_torch.obs.tracing import (  # noqa: F401
    PhaseTracer,
    get_tracer,
    trace_phase,
)

# One-shot processes bank their metrics via DISTLR_METRICS_SNAPSHOT=<path>
# instead of holding a port.
install_snapshot_atexit()
