"""Trace conformance: replay a real run's artifacts through the model.

The executable spec (:mod:`~distlr_tpu_torch.analysis.protocol.spec`) fixes
what a correct run may OBSERVABLY do; this module checks that a real
run's artifacts — dtrace span journals (Python clients and the native
server's ``--trace_journal``, one schema), and the chaos proxy's
canonical event log — stay inside those rules.  Observational
refinement, not re-execution: the artifacts are projected onto the
model's observable alphabet and every projected event must be
explicable by the spec.  Every violation cites ``file:line`` — the
exact journal line that cannot have come from a conforming run.

What is checked (each rule names the spec clause it projects):

* **schemas** — the chaos event log must carry the pinned ``schema: 1``
  header (an unknown or headerless log is REJECTED loudly: silently
  misparsing an old log would vacuously "conform"); span-journal lines
  must parse and carry the one shared span schema.
* **chaos log sanity** — event kinds within the fault alphabet the
  model injects; one-shot resets fire at most once per (link, fault);
  per-(link, fault) delay op offsets are UNIQUE (the proxy claims each
  op index exactly once under its link lock — a duplicate means the
  log did not come from one deterministic run; note the canonical log
  is value-sorted, so offsets need not appear in order).
* **per-handler protocol tags** — every native ``kv.*`` span's op /
  codec / optimizer tags must name protocol identities the spec knows,
  and a sign-coded push is only explicable under the signsgd optimizer
  (kHello advertises kCapCodecSign only there — spec invariant I4
  observed from the outside).
* **journal order** — spans land in a journal at COMPLETION, so per
  writer thread the end timestamps are non-decreasing (within a
  configurable slop); an out-of-order journal cannot have been written
  by the runtime and fails with the offending line cited.
* **span-tree refinement** — within one trace, a server handler span
  must be parented under a client op span of the compatible
  ``ps.*`` class (the kv_client stamps exactly one frame per op — spec
  delivery-proof rule), and a child must nest inside its same-file
  parent's window; ``ps.reroute`` instants must carry non-decreasing
  membership epochs bounded by the wire's u16 aux ceiling.
"""

from __future__ import annotations

import dataclasses
import json
import os

from distlr_tpu_torch.analysis.protocol import spec as S
from distlr_tpu_torch.ps import wire

#: the chaos canonical event log schema this replayer speaks (the
#: header is pinned by `ChaosFabric.events_doc` / `launch chaos`)
CHAOS_SCHEMA = 1

#: the fault alphabet the model injects — event kinds outside it are
#: not explicable (distlr_tpu_torch/chaos/plan.py FAULT_KINDS twin, plus the
#: proxy's partition_refused sub-kind rides the partition counter only)
FAULT_KINDS = ("delay", "throttle", "reset", "partition")

#: which client op spans may parent a given native handler span
#: (ps/client.py stamps `ps.<op>`; kv_server.cc logs the handler name)
HANDLER_PARENTS = {
    "kv.push": ("ps.push", "ps.push_init", "ps.push_init_opt_state"),
    "kv.pull": ("ps.pull", "ps.pull_chunked", "ps.pull_rows",
                "ps.pull_opt_state"),
    "kv.push_pull": ("ps.push_pull",),
}

CODEC_TAGS = tuple(S.CODEC_NAMES.values())
OPTIMIZER_TAGS = ("sgd", "ftrl", "signsgd")

#: default tolerance for journal-order / nesting checks, microseconds.
#: Within one process a record's end time is start-wall + perf-counter
#: duration, so completion order tracks end timestamps to well under a
#: millisecond; 5ms absorbs NTP slew without masking real reorderings.
DEFAULT_SLOP_US = 5_000.0


@dataclasses.dataclass(frozen=True)
class Violation:
    """One non-conforming artifact line — ``file:line`` citable."""

    file: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.message}"


# ---------------------------------------------------------------------------
# chaos canonical event log
# ---------------------------------------------------------------------------


def load_chaos_events(path: str) -> tuple[list, list]:
    """Parse a ``launch chaos --events-path`` log.  Returns
    ``(events, violations)`` where events are ``(link, kind, detail)``
    triples.  Unknown or missing schema REJECTS the whole file — a
    conformance replay must never silently misparse an old log."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [], [Violation(path, 1, f"unreadable chaos event log: {e}")]
    if not isinstance(doc, dict) or "schema" not in doc:
        return [], [Violation(
            path, 1,
            "chaos event log carries no schema header (pre-pinning "
            f"format?) — this replayer speaks schema {CHAOS_SCHEMA} "
            "only and refuses to guess at field meanings")]
    if doc.get("schema") != CHAOS_SCHEMA:
        return [], [Violation(
            path, 1,
            f"chaos event log schema {doc.get('schema')!r} != the "
            f"pinned {CHAOS_SCHEMA} — refusing to misparse")]
    events, out = [], []
    for i, ev in enumerate(doc.get("events", ())):
        if (not isinstance(ev, list) or len(ev) != 3
                or not isinstance(ev[2], dict)):
            out.append(Violation(
                path, 1, f"events[{i}] is not a [link, kind, detail] "
                f"triple: {ev!r}"))
            continue
        events.append((ev[0], ev[1], ev[2]))
    return events, out


def check_chaos_events(path: str) -> list[Violation]:
    """The event-log sanity rules (see module docstring)."""
    events, out = load_chaos_events(path)
    resets_seen: set = set()
    delay_ops_seen: set = set()
    for i, (link, kind, detail) in enumerate(events):
        where = f"events[{i}]"
        if kind not in FAULT_KINDS:
            out.append(Violation(
                path, 1, f"{where}: fault kind {kind!r} is outside the "
                f"model's alphabet {FAULT_KINDS}"))
            continue
        if kind == "reset":
            key = (link, detail.get("fault"))
            if key in resets_seen:
                out.append(Violation(
                    path, 1, f"{where}: reset fault {detail.get('fault')} "
                    f"on link {link} fired twice — resets are one-shot "
                    "per (link, fault) in the proxy"))
            resets_seen.add(key)
        if kind == "delay" and "op" in detail:
            # NB: uniqueness, not order — the canonical log is
            # value-sorted, so a jittered plan's varying `ms` field
            # legitimately reorders offsets within one (link, fault)
            key = (link, detail.get("fault"), detail["op"])
            if key in delay_ops_seen:
                out.append(Violation(
                    path, 1, f"{where}: delay op offset {detail['op']} "
                    f"on link {link} fault {detail.get('fault')} "
                    "appears twice — the proxy claims each op index "
                    "exactly once under the link lock"))
            delay_ops_seen.add(key)
        tid = detail.get("trace")
        if tid is not None:
            try:
                int(str(tid), 16)
            except ValueError:
                out.append(Violation(
                    path, 1, f"{where}: trace id {tid!r} is not hex"))
    return out


# ---------------------------------------------------------------------------
# span journals (Python dtrace + native --trace_journal, one schema)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpanRec:
    file: str
    line: int
    doc: dict

    @property
    def name(self) -> str:
        return self.doc.get("name", "")

    @property
    def end_us(self) -> float:
        return float(self.doc.get("ts", 0.0)) + float(self.doc.get("dur",
                                                                   0.0))


def load_span_journal(path: str) -> tuple[list, list]:
    """Every well-formed record of one journal as :class:`SpanRec`,
    plus violations for lines that cannot be span-schema records.  A
    torn FINAL line is tolerated (the batched-flush contract); a torn
    line mid-file is not."""
    recs, out = [], []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return [], [Violation(path, 1, f"unreadable span journal: {e}")]
    for n, raw in enumerate(lines, start=1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            doc = json.loads(raw)
        except ValueError:
            if n == len(lines):
                continue  # torn tail: the documented crash shape
            out.append(Violation(path, n, "unparseable journal line "
                                          "mid-file (not a torn tail)"))
            continue
        typ = doc.get("type")
        if typ == "meta":
            continue
        if typ == "clock":
            # the traced-kHello clock probe (symmetric-RTT offset per
            # server) — per-peer offsets, no ordering semantics
            if "peer" not in doc or "offset_s" not in doc:
                out.append(Violation(
                    path, n, "clock record missing peer/offset_s"))
            continue
        if typ not in ("span", "instant"):
            out.append(Violation(
                path, n, f"unknown journal record type {typ!r}"))
            continue
        if typ == "span":
            missing = [k for k in ("name", "trace", "span", "ts", "dur")
                       if k not in doc]
            if missing:
                out.append(Violation(
                    path, n, f"span record missing {missing}"))
                continue
            bad_num = [k for k in ("ts", "dur")
                       if not isinstance(doc[k], (int, float))
                       or isinstance(doc[k], bool)]
            if bad_num:
                # validated HERE so every downstream arithmetic check
                # can trust the fields — artifacts are untrusted input
                # and a crash would take the whole lint runner down
                out.append(Violation(
                    path, n, f"span fields {bad_num} are not numeric"))
                continue
            if float(doc["dur"]) < 0:
                out.append(Violation(
                    path, n, f"span {doc['name']!r} has negative dur "
                    f"{doc['dur']}"))
            for k in ("trace", "span", "parent"):
                v = doc.get(k)
                if v is None:
                    continue
                try:
                    int(str(v), 16)
                except ValueError:
                    out.append(Violation(
                        path, n, f"span field {k}={v!r} is not hex"))
        elif not isinstance(doc.get("ts"), (int, float)) \
                or isinstance(doc.get("ts"), bool):
            out.append(Violation(
                path, n, f"instant ts {doc.get('ts')!r} is not numeric"))
            continue
        recs.append(SpanRec(path, n, doc))
    return recs, out


def _check_handler_tags(rec: SpanRec) -> list[Violation]:
    """Protocol-identity tags of a native ``kv.*`` handler span."""
    out = []
    args = rec.doc.get("args", {})
    op = args.get("op")
    # the native TraceLog repeats the span name as the op tag
    # ("kv.push"); the bare op-name spelling is accepted too
    if op is not None and \
            (op[3:] if op.startswith("kv.") else op) \
            not in S.OP_NAMES.values():
        out.append(Violation(rec.file, rec.line,
                             f"kv handler op tag {op!r} is not a "
                             "protocol op"))
    codec = args.get("codec")
    if codec is not None and codec not in CODEC_TAGS:
        out.append(Violation(rec.file, rec.line,
                             f"codec tag {codec!r} is not a wire codec "
                             f"({CODEC_TAGS})"))
    optimizer = args.get("optimizer")
    if optimizer is not None and optimizer not in OPTIMIZER_TAGS:
        out.append(Violation(rec.file, rec.line,
                             f"optimizer tag {optimizer!r} unknown"))
    if codec == "sign" and optimizer not in (None, "signsgd"):
        out.append(Violation(
            rec.file, rec.line,
            "sign-coded push at a non-signsgd server: kHello advertises "
            "kCapCodecSign only under --optimizer=signsgd, so a "
            "conforming negotiation cannot produce this frame "
            "(spec invariant I4)"))
    if args.get("sync") not in (None, 0, 1):
        out.append(Violation(rec.file, rec.line,
                             f"sync tag {args.get('sync')!r} not 0/1"))
    return out


def _check_journal_order(recs: list, slop_us: float) -> list[Violation]:
    """Per writer thread, records land at completion: end timestamps
    are non-decreasing (within slop).  The native journal serializes
    all handler threads under one mutex, and its tid is the pid — the
    same per-tid rule covers both."""
    out = []
    last: dict = {}
    for rec in recs:
        tid = rec.doc.get("tid", 0)
        end = rec.end_us
        prev = last.get(tid)
        if prev is not None and end < prev - slop_us:
            out.append(Violation(
                rec.file, rec.line,
                f"journal out of order: record ends at {end:.1f}us but "
                f"an earlier line of tid {tid} ended at {prev:.1f}us "
                f"(> {slop_us:.0f}us slop) — spans land at completion, "
                "a conforming writer cannot produce this"))
        if prev is None or end > prev:
            last[tid] = end
    return out


def _check_trace_trees(by_file: dict, slop_us: float,
                       require_parents: bool) -> list[Violation]:
    out = []
    all_spans: dict = {}        # span id (int) -> SpanRec
    for recs in by_file.values():
        for rec in recs:
            if rec.doc.get("type") != "span":
                continue
            try:
                all_spans[int(str(rec.doc["span"]), 16)] = rec
            except (KeyError, ValueError):
                continue
    for recs in by_file.values():
        for rec in recs:
            doc = rec.doc
            if doc.get("type") == "instant" and doc.get(
                    "name") == "ps.reroute":
                epoch = doc.get("args", {}).get("epoch")
                try:
                    bad = epoch is not None and not (
                        0 <= int(epoch) <= wire.AUX_MAX)
                except (TypeError, ValueError):
                    bad = True
                if bad:
                    out.append(Violation(
                        rec.file, rec.line,
                        f"ps.reroute epoch {epoch!r} outside the u16 "
                        f"MsgHeader::aux range [0, {wire.AUX_MAX}]"))
                continue
            if doc.get("type") != "span":
                continue
            name = rec.name
            if name.startswith("kv."):
                out.extend(_check_handler_tags(rec))
            parent = doc.get("parent")
            if parent is None:
                if require_parents and name in HANDLER_PARENTS:
                    # a parentless handler span contradicts the
                    # one-stamp-per-op rule just as hard as a dangling
                    # parent id does
                    out.append(Violation(
                        rec.file, rec.line,
                        f"{name} span carries no parent at all — the "
                        "kv_client stamps each traced op exactly once, "
                        "so a handler span must parent under a client "
                        "op span"))
                continue
            try:
                pid = int(str(parent), 16)
            except ValueError:
                continue  # already reported by the loader
            prec = all_spans.get(pid)
            if prec is None:
                if require_parents and name in HANDLER_PARENTS:
                    out.append(Violation(
                        rec.file, rec.line,
                        f"{name} span has no parent span "
                        f"{parent} in any provided journal — the "
                        "kv_client stamps each traced op exactly once, "
                        "so a handler span's client op span must exist"))
                continue
            if name in HANDLER_PARENTS and \
                    prec.name not in HANDLER_PARENTS[name]:
                out.append(Violation(
                    rec.file, rec.line,
                    f"{name} span parented under {prec.name!r} "
                    f"({prec.file}:{prec.line}) — the spec only lets "
                    f"{HANDLER_PARENTS[name]} issue this handler"))
            # same-file nesting: no cross-host clock question there
            if prec.file == rec.file:
                p0 = float(prec.doc["ts"])
                p1 = prec.end_us
                if (float(doc["ts"]) < p0 - slop_us
                        or rec.end_us > p1 + slop_us):
                    out.append(Violation(
                        rec.file, rec.line,
                        f"{name} span [{doc['ts']}, {rec.end_us:.1f}]us "
                        f"escapes its parent {prec.name} window "
                        f"[{p0}, {p1:.1f}]us ({prec.file}:{prec.line}) "
                        "— a child span cannot outlive its parent in "
                        "one process"))
    # ps.reroute epochs non-decreasing per file
    for path, recs in by_file.items():
        last_epoch = None
        for rec in recs:
            if rec.doc.get("type") != "instant" or \
                    rec.name != "ps.reroute":
                continue
            epoch = rec.doc.get("args", {}).get("epoch")
            try:
                epoch = int(epoch)
            except (TypeError, ValueError):
                continue  # absent/malformed: reported by the aux check
            if last_epoch is not None and epoch < last_epoch:
                out.append(Violation(
                    rec.file, rec.line,
                    f"ps.reroute epoch went backwards ({last_epoch} -> "
                    f"{epoch}) — membership epochs only advance"))
            last_epoch = epoch
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_run(span_journals=(), chaos_events: str | None = None, *,
              require_parents: bool = False,
              slop_us: float = DEFAULT_SLOP_US) -> list[Violation]:
    """Conformance-check one run's artifacts.  ``span_journals`` is an
    iterable of journal paths (client and native mixed — one schema);
    ``chaos_events`` the canonical event log path, if the run rode a
    fault plan.  ``require_parents`` should be True for runs captured
    at ``--trace-sample 1.0`` (every handler span's client op span is
    then guaranteed journaled)."""
    out: list[Violation] = []
    by_file: dict = {}
    for path in span_journals:
        recs, vs = load_span_journal(path)
        out.extend(vs)
        by_file[path] = recs
        out.extend(_check_journal_order(recs, slop_us))
    out.extend(_check_trace_trees(by_file, slop_us, require_parents))
    if chaos_events is not None:
        out.extend(check_chaos_events(chaos_events))
    return out


def run_dir_journals(run_dir: str) -> list:
    """Every span journal of an ``--obs-run-dir`` tree.  The launch
    convention (``ServerGroup(trace_journal_dir=...)`` wired by
    ``launch ps-server --obs-run-dir``) puts native ``kvserver-*``
    journals in the SAME ``spans/`` directory as the Python ones, so
    one listing covers both; ``native/`` and ``trace_journal/``
    subdirectories are scanned too for runs (like the witnesses) that
    keep the native journals apart."""
    out = []
    for sub in ("spans", "native", "trace_journal"):
        d = os.path.join(run_dir, sub)
        if os.path.isdir(d):
            out += sorted(os.path.join(d, f) for f in os.listdir(d)
                          if f.endswith(".jsonl"))
    return out


def check_run_dir(run_dir: str, chaos_events: str | None = None, *,
                  require_parents: bool = False) -> list[Violation]:
    return check_run(run_dir_journals(run_dir), chaos_events,
                     require_parents=require_parents)


def fixtures_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def check_fixtures() -> list[Violation]:
    """The checked-in witness: journals + chaos event log captured from
    a REAL 2-server chaos run at ``--trace-sample 1.0`` (see
    ``fixtures/README.md``).  The default protocol pass replays them so
    ``python -m distlr_tpu_torch.analysis`` exercises the whole replay path
    even on machines that never built the native server."""
    d = fixtures_dir()
    journals = sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(".jsonl"))
    chaos = os.path.join(d, "chaos_events.json")
    return check_run(journals,
                     chaos if os.path.exists(chaos) else None,
                     require_parents=True)
