"""Conformance witnesses: real runs whose artifacts replay through the
model.

Two scripted runs, both at ``--trace-sample 1.0`` so every handler
span's client op span is journaled (``require_parents`` replay):

* :func:`chaos_witness` — a 2-server async group behind the chaos
  proxy (a per-op delay plus a one-shot reset-after-delivery), a
  retrying client pushing/pulling through the faults.  Artifacts: the
  client span journal, both native ``--trace_journal`` files, and the
  schema-pinned canonical event log.
* :func:`resize_witness` — a 2-server elastic group live-shrunk to 1
  under a route-following client (epoch fence + re-route mid-traffic).

The tests run both against temporary directories (every chaos/elastic
end-to-end run doubling as a conformance witness is the point);
``python -m distlr_tpu_torch.analysis.protocol --regen-fixtures`` banks the
chaos witness's artifacts under ``fixtures/`` so the default lint pass
can replay a REAL run on machines that never built the native server.

This module (unlike the rest of ``analysis/``) imports the live PS
stack — numpy, the ctypes client, spawned native servers.  It is only
imported by tests and the fixture regenerator, never by the lint pass.
"""

from __future__ import annotations

import json
import os
import shutil


def chaos_witness(out_dir: str) -> dict:
    """Run the traced 2-server chaos scenario; returns
    ``{"journals": [...], "chaos_events": path}``."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.chaos import ChaosFabric, parse_plan  # noqa: PLC0415
    from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup  # noqa: PLC0415

    os.makedirs(out_dir, exist_ok=True)
    native_dir = os.path.join(out_dir, "native")
    dim = 8
    plan = parse_plan({
        "seed": 14,
        "faults": [
            {"kind": "delay", "delay_ms": 1, "links": [0]},
            # sever the reply of a DELIVERED frame mid-run: the
            # push-outcome-unknown path the model absorbs
            {"kind": "reset", "after_ops": 4, "links": [1]},
        ],
    })
    dtrace.reset_for_tests()
    dtrace.configure(out_dir, "worker", 0, sample=1.0)
    try:
        with ServerGroup(2, 1, dim=dim, sync=False,
                         trace_journal_dir=native_dir) as group:
            with ChaosFabric(group.hosts, plan) as fabric:
                kv = KVWorker(fabric.hosts, dim, client_id=1,
                              sync_group=False, timeout_ms=2000,
                              retry=RetryPolicy(attempts=4,
                                                backoff_ms=20.0,
                                                seed=14))
                try:
                    for step in range(7):
                        with dtrace.use(dtrace.new_trace()), \
                                dtrace.span("train.step",
                                            tags={"step": step}):
                            if step == 0:
                                kv.push_init(np.zeros(dim, np.float32))
                            else:
                                kv.push(np.full(dim, 0.5, np.float32))
                                kv.pull()
                finally:
                    kv.close()
                events_path = os.path.join(out_dir, "chaos_events.json")
                with open(events_path, "w") as f:
                    json.dump(fabric.events_doc(), f, indent=1)
        dtrace.flush()
    finally:
        dtrace.reset_for_tests()
    journals = [os.path.join(out_dir, "spans", "worker-0.jsonl")]
    for rank in range(2):
        p = os.path.join(native_dir, f"kvserver-{rank}.jsonl")
        if os.path.exists(p):
            journals.append(p)
    return {"journals": journals, "chaos_events": events_path}


def resize_witness(out_dir: str) -> dict:
    """Run the traced live-resize scenario (2 -> 1 under a
    route-following client); returns ``{"journals": [...]}``."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.ps.membership import MembershipCoordinator  # noqa: PLC0415

    os.makedirs(out_dir, exist_ok=True)
    native_dir = os.path.join(out_dir, "native")
    dim = 8
    dtrace.reset_for_tests()
    dtrace.configure(out_dir, "worker", 0, sample=1.0)
    try:
        with ServerGroup(2, 1, dim=dim, sync=False,
                         trace_journal_dir=native_dir) as group:
            coord = MembershipCoordinator(group)
            kv = KVWorker(group.hosts, dim, client_id=1,
                          sync_group=False, timeout_ms=2000,
                          epoch=coord.epoch, route=coord.layout)
            try:
                with dtrace.use(dtrace.new_trace()), \
                        dtrace.span("train.step", tags={"step": 0}):
                    kv.push_init(np.zeros(dim, np.float32))
                    kv.push(np.ones(dim, np.float32))
                # the coordinator journals its reshard.resize /
                # reshard.migrate spans under its own root trace
                with dtrace.use(dtrace.new_trace()):
                    coord.resize(1)
                # the next op bounces off the fence / dead rank and
                # re-routes through the coordinator's new layout
                with dtrace.use(dtrace.new_trace()), \
                        dtrace.span("train.step", tags={"step": 1}):
                    kv.push(np.ones(dim, np.float32))
                    kv.pull()
            finally:
                kv.close()
        dtrace.flush()
    finally:
        dtrace.reset_for_tests()
    journals = [os.path.join(out_dir, "spans", "worker-0.jsonl")]
    for rank in range(3):
        p = os.path.join(native_dir, f"kvserver-{rank}.jsonl")
        if os.path.exists(p):
            journals.append(p)
    return {"journals": journals}


def regen_fixtures(fixtures_dir: str) -> list:
    """Re-bank the chaos witness's artifacts as the checked-in
    conformance fixture (provenance in ``fixtures/README.md``)."""
    import tempfile  # noqa: PLC0415

    with tempfile.TemporaryDirectory() as tmp:
        arts = chaos_witness(tmp)
        os.makedirs(fixtures_dir, exist_ok=True)
        out = []
        for j in arts["journals"]:
            dst = os.path.join(fixtures_dir, os.path.basename(j))
            shutil.copy(j, dst)
            out.append(dst)
        dst = os.path.join(fixtures_dir, "chaos_events.json")
        shutil.copy(arts["chaos_events"], dst)
        out.append(dst)
    return out
