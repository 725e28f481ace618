"""Observability of the port: metrics registry, phase tracing, exporters.

Counterpart of ``distlr_tpu/obs/``: one process-wide
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
bytes), the distributed tracing of :mod:`distlr_tpu_torch.obs.dtrace`
(span journals, the flight recorder, ``launch trace-agg``), and the fleet
tools: federation and derived alerts (:mod:`~distlr_tpu_torch.obs.federate`,
``launch obs-agg``), the embedded time-series store and SLO engine
(:mod:`~distlr_tpu_torch.obs.tsdb`, :mod:`~distlr_tpu_torch.obs.slo`), the
structured fleet log (:mod:`~distlr_tpu_torch.obs.log`), the continuous
profiler (:mod:`~distlr_tpu_torch.obs.profile`), incident bundles
(:mod:`~distlr_tpu_torch.obs.incident`), ``launch top``
(:mod:`~distlr_tpu_torch.obs.top`) and the generated series reference
``METRICS.md`` (:mod:`~distlr_tpu_torch.obs.metrics_doc`).

Metric namespace, as in the JAX package:

* ``distlr_ps_server_*``  — ServerGroup/ServerSupervisor lifecycle
* ``distlr_ps_client_*``  — native KV client ops, latency, bytes
* ``distlr_train_*``      — step/sample counters, rates, staleness
* ``distlr_serve_*``, ``distlr_route_*``, ``distlr_tenant_*``,
  ``distlr_rollout_*`` — the scoring tier
* ``distlr_feedback_*``, ``distlr_online_*`` — the online loop
* ``distlr_phase_seconds``— per-phase histogram behind the tracer
* ``distlr_fleet_*`` / ``distlr_alert_*`` — fleet-scrape meta-series and
  derived alert gauges (:mod:`distlr_tpu_torch.obs.federate`)
* ``distlr_tsdb_*``, ``distlr_slo_*`` — the aggregator's time-series store
  and SLO engine
* ``distlr_log_*``, ``distlr_incident_*``, ``distlr_autopilot_*`` — the
  fleet log, the incident engine, the autopilot
* ``distlr_trace_*``      — distributed-trace span, journal and flight-
  recorder accounting (:mod:`distlr_tpu_torch.obs.dtrace`)
* ``distlr_prof_*``       — continuous-profiling sampler, window and burst
  accounting (:mod:`distlr_tpu_torch.obs.profile`)
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
from distlr_tpu_torch.obs.federate import (  # noqa: F401
    AlertThresholds,
    FleetMergeError,
    FleetScraper,
    discover_endpoints,
    evaluate_alerts,
    merge_snapshots,
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
