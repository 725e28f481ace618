"""Executable small-step spec of the KV protocol state machine.

This is the semantic twin of the prose in ``ps/native/kv_protocol.h``
and the retry/membership docstrings of :mod:`distlr_tpu_torch.ps.client`:
the same rules, written as an enumerable transition system the
explicit-state checker (:mod:`~distlr_tpu_torch.analysis.protocol.checker`)
can search exhaustively.  Wire-level identities (op codes, flag bits,
capability bits, the fence reply shape) come from
:mod:`distlr_tpu_torch.ps.wire` — the ONE Python protocol mirror — so the
wire-parity lint covers this module like any other framing site, and a
drifted constant fails the build before it can mis-model the protocol.

Modeling choices (every abstraction is stated, none silent):

* **granularity** — one step is one atomic protocol event: a client
  issuing an op (its per-rank slice frames enter the per-connection
  FIFOs — TCP ordering per connection, full interleaving across
  connections), a server processing ONE frame, a client consuming ONE
  reply, a fault firing, or one coordinator stage.  Delay faults and
  cross-connection reordering are interleaving, which the checker
  explores exhaustively; an explicit ``delay`` fault additionally
  pins a stream stalled across other events.
* **values are not modeled** — a push is a unique id; servers record
  which push ids touched which coordinate.  "Applied <= issued, never
  double-applied" is then exact counting, and FTRL z/n migration is
  multiset preservation (z is a sum: order-insensitive, copy-count-
  sensitive — exactly what a drain must preserve).
* **delivery proof** — frames enqueue at issue time (bytes handed to
  the kernel: ``kv_op_delivery_began`` true from then on).  A slice
  aimed at an already-dead connection stays ``unsent`` (nothing left
  the client — the one case the real retry ladder may re-issue a push).
* **negotiation** — connect + kHello + epoch announce are one atomic
  step per client (the handshake is one blocking call in the real
  client); what is CHECKED is its outcome under every interleaving of
  resizes/faults around it: capability intersection, mixed-vintage
  downgrade, announce-only-if-every-rank-speaks-kEpoch.

The ``Spec`` flags name the historical fixes; reverting one
(:mod:`~distlr_tpu_torch.analysis.protocol.mutants`) must make the checker
rediscover the corresponding production bug as a counterexample
schedule.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple

from distlr_tpu_torch.ps import wire

# -- wire-derived identities (lint-checked against kv_protocol.h) --------
OP_NAMES = {
    wire.OP_PUSH: "push",
    wire.OP_PULL: "pull",
    wire.OP_BARRIER: "barrier",
    wire.OP_SHUTDOWN: "shutdown",
    wire.OP_HELLO: "hello",
    wire.OP_STATS: "stats",
    wire.OP_PUSH_PULL: "push_pull",
    wire.OP_EPOCH: "epoch",
}

CODEC_NAMES = {
    wire.CODEC_NONE: "none",
    wire.CODEC_INT8: "int8",
    wire.CODEC_SIGN: "sign",
}

#: capability bit a codec id needs before a client may set its flag bits
CODEC_CAP = {
    wire.CODEC_INT8: wire.CAP_CODEC_INT8,
    wire.CODEC_SIGN: wire.CAP_CODEC_SIGN,
}

#: every capability a current-vintage server advertises
FULL_CAPS = (wire.CAP_CODEC_INT8 | wire.CAP_CODEC_SIGN
             | wire.CAP_TRACE | wire.CAP_EPOCH)
#: a pre-codec / pre-epoch vintage (kHello answered empty)
LEGACY_CAPS = 0

#: the fence reply shape (kv_protocol.h kEpoch ANNOUNCE): op is kEpoch —
#: NOT the echoed data op — with the error+response flags; aux carries
#: the server's current epoch.  `classify_reply` below is the client's
#: side of the same contract.
FENCE_OP = wire.OP_EPOCH
FENCE_FLAGS = wire.FLAG_RESPONSE | wire.FLAG_ERROR


def classify_reply(op: int, flags: int) -> str:
    """The client's reply classification — the exact discrimination
    :meth:`distlr_tpu_torch.ps.client.KVWorker._check` performs from wire
    bytes: a fence is ``op == kEpoch`` with the error flag (transient
    by design: re-fetch the layout and re-route); any OTHER errored op
    is a protocol rejection (deterministic caller error, never
    retried); everything else is a plain response."""
    if flags & wire.FLAG_ERROR:
        return "fence" if op == FENCE_OP else "reject"
    return "ok"


def frame_bytes(req: "Req") -> bytes:
    """A model frame rendered as REAL wire bytes (MsgHeader via the
    mirror's struct) — ties counterexample schedules to the byte layout
    and keeps this module an honest framing site for the lint."""
    flags = (req.codec << wire.CODEC_SHIFT) & wire.CODEC_MASK
    aux = req.aux & wire.AUX_MAX
    return wire.HEADER_STRUCT.pack(wire.MAGIC, req.op, flags, aux,
                                   req.client, 0, len(req.coords))


# -- frames --------------------------------------------------------------
#: client->server frame: one op slice on one connection.  ``push`` is
#: the op's unique id (None for barrier votes), ``coords`` the global
#: coordinates this slice covers, ``codec`` the negotiated codec id.
Req = namedtuple("Req", "op aux client push coords codec")
#: server->client reply.  ``intent`` is a model-only annotation of what
#: the server MEANT ("ok" | "fence" | "reject") — the client must
#: recover it from (op, flags) alone; invariant I3 fails if it cannot.
Resp = namedtuple("Resp", "op flags aux push intent")


@dataclasses.dataclass(frozen=True)
class Spec:
    """The protocol rules, with the named historical fixes revertible.

    Every flag defaults to the FIXED behavior; a mutant reverts exactly
    one and the checker must rediscover the production bug it caused.
    """

    #: the barrier fix: HandleBarrier dedups votes by client_id,
    #: replacing a stale entry's fd — False reverts to blind append,
    #: where a reconnecting worker's re-vote races the old connection's
    #: DropConnection rollback and double-counts.
    barrier_dedup_by_client: bool = True
    #: the membership fix: a gradient push bounced by a membership
    #: fence (or dead against a retired rank) after delivery began is
    #: ABSORBED as push_outcome_unknown — False reverts to re-issuing
    #: it through the new layout, a silent double-apply on every rank
    #: that applied its slice before the flip.
    absorb_fenced_push: bool = True
    #: protocol design pin (kv_protocol.h kEpoch): fence replies carry
    #: op=kEpoch, never the echoed data op — False makes fences
    #: indistinguishable from kError config rejections (invariant I3).
    fence_uses_epoch_op: bool = True


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One small configuration the checker explores exhaustively.

    ``programs`` maps client id -> a tuple of ops, each
    ``("push", coords)`` / ``("pull", coords)`` / ``("barrier", gen)``.
    ``server_caps`` overrides per-rank kHello capability masks (index ->
    mask) for mixed-vintage groups.  ``resize`` is a target server
    count (one live resize mid-run) or None.  ``faults`` is the allowed
    chaos alphabet subset and ``fault_budget`` how many may fire.
    """

    name: str
    dim: int = 4
    num_servers: int = 2
    programs: tuple = ()
    codec: int = wire.CODEC_NONE          # what clients WANT to push
    optimizer: str = "sgd"                # sgd | ftrl
    server_caps: tuple = ()               # ((rank, caps), ...) overrides
    resize: int | None = None
    faults: tuple = ("reset", "reset_mid", "delay", "partition")
    fault_budget: int = 1

    @property
    def num_workers(self) -> int:
        return len(self.programs)

    def caps_of(self, rank: int) -> int:
        for r, caps in self.server_caps:
            if r == rank:
                return caps
        return FULL_CAPS


def split_ranges(dim: int, n: int) -> tuple:
    """The ServerGroup range split: dim sliced into n near-equal
    contiguous ranges (lo, hi)."""
    base, rem = divmod(dim, n)
    out, lo = [], 0
    for r in range(n):
        hi = lo + base + (1 if r < rem else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


# -- mutable world (cloned per transition, frozen for hashing) -----------


class ServerS:
    __slots__ = ("sid", "lo", "hi", "epoch", "caps", "alive",
                 "partitioned", "barrier", "released", "zn")

    def __init__(self, sid, lo, hi, epoch, caps):
        self.sid = sid
        self.lo, self.hi = lo, hi
        self.epoch = epoch
        self.caps = caps
        self.alive = True
        self.partitioned = False
        #: gen -> tuple of (client_id, conn_id) votes, insertion order
        self.barrier: dict = {}
        self.released: frozenset = frozenset()
        #: coord -> tuple of applied push ids (the FTRL z/n proxy: a
        #: sum is order-insensitive but copy-count-sensitive)
        self.zn: dict = {}

    def clone(self):
        s = ServerS(self.sid, self.lo, self.hi, self.epoch, self.caps)
        s.alive, s.partitioned = self.alive, self.partitioned
        s.barrier = {g: v for g, v in self.barrier.items()}
        s.released = self.released
        s.zn = dict(self.zn)
        return s

    def freeze(self):
        return (self.sid, self.lo, self.hi, self.epoch, self.caps,
                self.alive, self.partitioned,
                tuple(sorted((g, v) for g, v in self.barrier.items())),
                tuple(sorted(self.released)),
                tuple(sorted((k, tuple(sorted(v)))
                             for k, v in self.zn.items())))


class ConnS:
    __slots__ = ("cid", "client", "server", "alive", "announced",
                 "delayed", "drop_done", "delivered", "req", "resp")

    def __init__(self, cid, client, server, announced):
        self.cid = cid
        self.client = client
        self.server = server
        self.alive = True
        self.announced = announced    # epoch announced on this conn (0 = none)
        self.delayed = False
        self.drop_done = False        # server processed the disconnect
        self.delivered = 0            # frames the server has dequeued
        self.req: tuple = ()          # FIFO of Req
        self.resp: tuple = ()         # FIFO of Resp

    def clone(self):
        c = ConnS(self.cid, self.client, self.server, self.announced)
        c.alive, c.delayed, c.drop_done, c.delivered = \
            self.alive, self.delayed, self.drop_done, self.delivered
        c.req, c.resp = self.req, self.resp
        return c

    def freeze(self):
        return (self.cid, self.client, self.server, self.alive,
                self.announced, self.delayed, self.drop_done,
                self.delivered, self.req, self.resp)


class ClientS:
    __slots__ = ("cid", "pc", "layout", "layout_epoch", "conns", "codec",
                 "op", "done", "absorbed")

    def __init__(self, cid):
        self.cid = cid
        self.pc = 0
        self.layout: tuple = ()       # ((sid, lo, hi), ...)
        self.layout_epoch = 0
        self.conns: dict = {}         # sid -> conn id
        self.codec = wire.CODEC_NONE
        #: in-flight op: (kind, push_id_or_gen, {sid: status}) where
        #: status in {"sent", "unsent", "ok", "unknown"} — or
        #: ("reroute", kind, push_id_or_gen) while waiting out a
        #: migration, or None
        self.op = None
        self.done = False
        self.absorbed: tuple = ()     # push ids absorbed as unknown-outcome

    def clone(self):
        c = ClientS(self.cid)
        c.pc = self.pc
        c.layout, c.layout_epoch = self.layout, self.layout_epoch
        c.conns = dict(self.conns)
        c.codec = self.codec
        if self.op is not None and isinstance(self.op[-1], dict):
            c.op = self.op[:-1] + (dict(self.op[-1]),)
        else:
            c.op = self.op
        c.done = self.done
        c.absorbed = self.absorbed
        return c

    def freeze(self):
        op = self.op
        if op is not None and isinstance(op[-1], dict):
            op = op[:-1] + (tuple(sorted(op[-1].items())),)
        return (self.cid, self.pc, self.layout, self.layout_epoch,
                tuple(sorted(self.conns.items())), self.codec, op,
                self.done, self.absorbed)


class CoordS:
    """The membership coordinator mid-resize (spawn -> fence -> drain ->
    commit -> activate), or idle."""

    __slots__ = ("phase", "epoch", "target", "new_ranges", "reuse",
                 "moves", "fenced", "drained", "pub_status")

    def __init__(self, epoch):
        self.phase = "idle"           # idle|begun|fenced|drained|done
        self.epoch = epoch            # published layout epoch
        self.target = None
        self.new_ranges: tuple = ()
        self.reuse: dict = {}         # new rank index -> old sid
        self.moves: tuple = ()        # ((old_sid, lo, hi, new_rank), ...)
        self.fenced: frozenset = frozenset()
        self.drained: frozenset = frozenset()
        self.pub_status = "active"    # what layout() reports to clients

    def clone(self):
        c = CoordS(self.epoch)
        for f in self.__slots__:
            setattr(c, f, getattr(self, f))
        return c

    def freeze(self):
        return (self.phase, self.epoch, self.target, self.new_ranges,
                tuple(sorted(self.reuse.items())), self.moves,
                tuple(sorted(self.fenced)), tuple(sorted(self.drained)),
                self.pub_status)


class World:
    """The whole model state.  ``violation`` is set (with a message) the
    step an invariant breaks — the checker stops there and rebuilds the
    schedule."""

    __slots__ = ("servers", "clients", "conns", "coord", "next_conn",
                 "issued", "applied", "faults_left", "violation")

    def __init__(self):
        self.servers: dict = {}
        self.clients: dict = {}
        self.conns: dict = {}
        self.coord: CoordS | None = None
        self.next_conn = 0
        self.issued: dict = {}        # push id -> coords tuple
        self.applied: dict = {}       # (push id, coord) -> apply count
        self.faults_left = 0
        self.violation: str | None = None

    def clone(self):
        w = World()
        w.servers = {k: v.clone() for k, v in self.servers.items()}
        w.clients = {k: v.clone() for k, v in self.clients.items()}
        w.conns = {k: v.clone() for k, v in self.conns.items()}
        w.coord = self.coord.clone() if self.coord else None
        w.next_conn = self.next_conn
        w.issued = dict(self.issued)
        w.applied = dict(self.applied)
        w.faults_left = self.faults_left
        w.violation = self.violation
        return w

    def freeze(self):
        return (tuple(s.freeze() for _, s in sorted(self.servers.items())),
                tuple(c.freeze() for _, c in sorted(self.clients.items())),
                tuple(c.freeze() for _, c in sorted(self.conns.items())),
                self.coord.freeze() if self.coord else None,
                self.next_conn,
                tuple(sorted(self.issued.items())),
                tuple(sorted(self.applied.items())),
                self.faults_left, self.violation)


def initial_world(sc: Scenario) -> World:
    w = World()
    for sid, (lo, hi) in enumerate(split_ranges(sc.dim, sc.num_servers)):
        w.servers[sid] = ServerS(sid, lo, hi, epoch=1, caps=sc.caps_of(sid))
    for cid in range(len(sc.programs)):
        w.clients[cid] = ClientS(cid)
    w.coord = CoordS(epoch=1)
    w.faults_left = sc.fault_budget if sc.faults else 0
    return w


# -- transition helpers --------------------------------------------------


def _owners(w: World, client: ClientS, coords) -> dict:
    """coords split by owning rank per the CLIENT's layout view (which
    may be stale mid-resize — exactly the straddle the fence catches)."""
    out: dict = {}
    for k in coords:
        for sid, lo, hi in client.layout:
            if lo <= k < hi:
                out.setdefault(sid, []).append(k)
                break
        else:
            raise AssertionError(f"coord {k} outside client layout")
    return {sid: tuple(ks) for sid, ks in out.items()}


def _connect(w: World, client: ClientS, sc: Scenario) -> bool:
    """Atomic connect + kHello + epoch announce against the client's
    current layout.  Returns False (connect refused) when any target
    rank is partitioned or dead — the caller leaves state untouched and
    the client retries under another interleaving (the real client's
    bounded poll).  Negotiation outcome per the protocol:

    * codec = wanted codec iff EVERY rank's capability mask advertises
      it (kv_negotiate_codec takes the group intersection), else dense;
    * epoch announced iff EVERY rank speaks kEpoch (kCapEpoch) — a
      kEpoch frame against a pre-epoch binary would never be answered.
    """
    for sid, _lo, _hi in client.layout:
        srv = w.servers[sid]
        if not srv.alive or srv.partitioned:
            return False
    caps = ~0
    for sid, _lo, _hi in client.layout:
        caps &= w.servers[sid].caps
    client.codec = (sc.codec if sc.codec == wire.CODEC_NONE
                    or caps & CODEC_CAP[sc.codec] else wire.CODEC_NONE)
    announce = client.layout_epoch if caps & wire.CAP_EPOCH else 0
    for sid, _lo, _hi in client.layout:
        # a still-open previous conn to this rank is closed client-side
        old = client.conns.get(sid)
        if old is not None and old in w.conns:
            w.conns[old].alive = False
        conn = ConnS(w.next_conn, client.cid, sid, announce)
        w.next_conn += 1
        w.conns[conn.cid] = conn
        client.conns[sid] = conn.cid
        # I4: the negotiation rules above make these unreachable; a
        # mutant (or future refactor) that breaks intersection/announce
        # gating trips them on the exact interleaving that desyncs
        if announce and not w.servers[sid].caps & wire.CAP_EPOCH:
            w.violation = (f"I4: client c{client.cid} announced epoch "
                           f"{announce} to pre-epoch rank s{sid} — the "
                           "frame would never be answered")
        if (client.codec != wire.CODEC_NONE
                and not w.servers[sid].caps & CODEC_CAP[client.codec]):
            w.violation = (f"I4: client c{client.cid} negotiated codec "
                           f"{CODEC_NAMES[client.codec]} but rank s{sid} "
                           "does not decode it — stream desync")
    return True


def _enqueue_slices(w: World, client: ClientS, kind: str, push, coords):
    """Issue one op: slice frames per owning rank, enqueued on live
    connections (delivery began); slices whose connection is already
    dead stay ``unsent`` (kv_op_delivery_began stays false for them)."""
    op = (wire.OP_PUSH if kind == "push"
          else wire.OP_PULL if kind == "pull" else wire.OP_BARRIER)
    slices = {}
    targets = (_owners(w, client, coords) if kind != "barrier"
               else {client.layout[0][0]: ()})
    for sid, ks in targets.items():
        conn = w.conns.get(client.conns.get(sid, -1))
        aux = push if kind == "barrier" else 0
        if conn is not None and conn.alive:
            conn.req = conn.req + (
                Req(op, aux, client.cid, push if kind != "barrier" else None,
                    ks, client.codec if kind == "push" else wire.CODEC_NONE),)
            slices[sid] = "sent"
        else:
            slices[sid] = "unsent"
    client.op = (kind, push, slices)


def _apply_push(w: World, srv: ServerS, req: Req):
    """Server-side gradient apply: exact per-coordinate counting.
    I1 ("applied <= issued and never double-applied") fails the moment
    any (push, coord) applies twice or a never-issued push applies."""
    if req.push not in w.issued:
        w.violation = f"I1: rank s{srv.sid} applied unissued push {req.push}"
        return
    for k in req.coords:
        n = w.applied.get((req.push, k), 0) + 1
        w.applied[(req.push, k)] = n
        if n > 1:
            w.violation = (f"I1: push {req.push} applied {n}x to coord "
                           f"{k} at rank s{srv.sid} — double-apply")
        srv.zn[k] = srv.zn.get(k, ()) + (req.push,)


def _release_barrier(w: World, srv: ServerS, gen: int, num_workers: int):
    votes = srv.barrier[gen]
    distinct = {c for c, _cid in votes}
    if len(distinct) < num_workers:
        w.violation = (
            f"I2: barrier gen {gen} released at rank s{srv.sid} with a "
            f"live unvoted client — votes {[c for c, _ in votes]} count "
            f"{len(votes)} but only {sorted(distinct)} distinct")
    del srv.barrier[gen]
    srv.released = srv.released | {gen}
    for _client, vcid in votes:
        conn = w.conns.get(vcid)
        if conn is not None and conn.alive:
            conn.resp = conn.resp + (
                Resp(wire.OP_BARRIER, wire.FLAG_RESPONSE, gen, None, "ok"),)


def _reply(w: World, srv: ServerS, conn: ConnS, req: Req, spec: Spec,
           num_workers: int):
    """Process ONE dequeued frame — the server dispatch loop's body."""
    name = OP_NAMES[req.op]
    # membership fence: every keyed data op on an epoch-announced
    # connection bounces when the server's epoch moved (payload already
    # fully read — the model dequeued the whole frame — so the stream
    # stays framed); barrier votes are not keyed and pass
    if (name in ("push", "pull", "push_pull") and conn.announced
            and conn.announced != srv.epoch):
        op = FENCE_OP if spec.fence_uses_epoch_op else req.op
        if conn.alive:
            conn.resp = conn.resp + (
                Resp(op, FENCE_FLAGS, srv.epoch, req.push, "fence"),)
        return
    if name == "push":
        if req.codec != wire.CODEC_NONE and not srv.caps & CODEC_CAP[req.codec]:
            w.violation = (f"I4: rank s{srv.sid} received codec "
                           f"{CODEC_NAMES[req.codec]} it cannot decode")
            return
        _apply_push(w, srv, req)
        if conn.alive:
            conn.resp = conn.resp + (
                Resp(wire.OP_PUSH, wire.FLAG_RESPONSE, 0, req.push, "ok"),)
    elif name == "pull":
        if conn.alive:
            conn.resp = conn.resp + (
                Resp(wire.OP_PULL, wire.FLAG_RESPONSE, 0, req.push, "ok"),)
    elif name == "barrier":
        gen = req.aux
        if gen in srv.released:
            if conn.alive:
                conn.resp = conn.resp + (
                    Resp(wire.OP_BARRIER, wire.FLAG_RESPONSE, gen, None,
                         "ok"),)
            return
        votes = srv.barrier.get(gen, ())
        if spec.barrier_dedup_by_client:
            # the barrier fix: one vote per CLIENT per generation — a
            # reconnecting worker's re-vote REPLACES the stale entry's
            # fd instead of appending a second live vote
            votes = tuple((c, conn.cid if c == req.client else vcid)
                          for c, vcid in votes)
            if not any(c == req.client for c, _ in votes):
                votes = votes + ((req.client, conn.cid),)
        else:
            votes = votes + ((req.client, conn.cid),)
        srv.barrier[gen] = votes
        if len(votes) >= num_workers:
            _release_barrier(w, srv, gen, num_workers)


def _client_consume(w: World, client: ClientS, sid: int, resp: Resp,
                    spec: Spec, sc: Scenario):
    """One reply consumed — classification + the retry/membership
    ladder's per-outcome rules."""
    cls = classify_reply(resp.op, resp.flags)
    if cls != resp.intent:
        w.violation = (
            f"I3: client c{client.cid} classified a reply (op="
            f"{OP_NAMES.get(resp.op, resp.op)}, flags={resp.flags:#x}) as "
            f"{cls!r} but the server meant {resp.intent!r} — fence/"
            "kError ambiguity")
        return
    if client.op is None:
        return  # late reply of an op the ladder already resolved
    kind, ident, slices = client.op[0], client.op[1], None
    if kind == "reroute":
        return  # already waiting out a migration; late replies ignored
    slices = client.op[2]
    if cls == "fence":
        # the membership layer: re-fetch layout, rebuild, and (pushes)
        # absorb-or-reissue per the membership flag.  Modeled as entering a
        # reroute phase; `client_reroute` completes it when the
        # coordinator publishes an ACTIVE layout.
        client.op = ("reroute", kind, ident)
        return
    if cls == "reject":
        client.op = None  # deterministic caller error: op aborts
        return
    if kind == "barrier":
        client.op = None
        client.pc += 1
    else:
        if slices.get(sid) == "sent":
            slices[sid] = "ok"
        if all(st in ("ok", "unknown") for st in slices.values()):
            client.op = None
            client.pc += 1


def _finish_op_if_resolved(client: ClientS):
    _kind, _ident, slices = client.op
    if all(st in ("ok", "unknown") for st in slices.values()):
        client.op = None
        client.pc += 1


# -- enumerating enabled transitions -------------------------------------


def successors(w: World, sc: Scenario, spec: Spec):
    """Yield ``(label, next_world)`` for every enabled atomic step."""
    # --- clients ---
    for cid, cl in sorted(w.clients.items()):
        if cl.done:
            continue
        # initial connect — only against an ACTIVE published layout
        # (mid-migration the coordinator reports `status: migrating`
        # and the real client polls instead of connecting)
        if not cl.conns and cl.op is None:
            if w.coord.pub_status != "active":
                continue
            nw = w.clone()
            ncl = nw.clients[cid]
            ncl.layout = tuple(
                (s.sid, s.lo, s.hi)
                for _, s in sorted(nw.servers.items()) if s.alive)
            ncl.layout_epoch = nw.coord.epoch
            if _connect(nw, ncl, sc):
                yield (f"c{cid}: connect + hello "
                       f"(epoch {ncl.layout_epoch}, codec "
                       f"{CODEC_NAMES[ncl.codec]})", nw)
            continue
        # issue the next program op
        if cl.op is None:
            if cl.pc >= len(sc.programs[cid]):
                nw = w.clone()
                nw.clients[cid].done = True
                yield (f"c{cid}: done", nw)
                continue
            kind, arg = sc.programs[cid][cl.pc]
            nw = w.clone()
            ncl = nw.clients[cid]
            if kind == "barrier":
                _enqueue_slices(nw, ncl, kind, arg, ())
                yield (f"c{cid}: vote barrier gen {arg}", nw)
            else:
                push = f"{kind[0]}{cid}.{cl.pc}"
                nw.issued[push] = tuple(arg)
                _enqueue_slices(nw, ncl, kind, push, tuple(arg))
                tgt = ",".join(f"s{s}" for s in ncl.op[2])
                yield (f"c{cid}: issue {kind} {push} coords {arg} "
                       f"-> {tgt}", nw)
            continue
        if cl.op[0] == "reroute":
            # fence recovery: blocked until the coordinator publishes an
            # ACTIVE layout (the real ladder's bounded poll), then one
            # atomic re-fetch + rebuild + renegotiate + resolve
            if w.coord.pub_status == "active":
                nw = w.clone()
                yield (_client_reroute(nw, nw.clients[cid], sc, spec), nw)
            continue
        # consume a reply
        for sid, ccid in sorted(cl.conns.items()):
            conn = w.conns.get(ccid)
            if conn is None or not conn.resp or not conn.alive:
                continue
            nw = w.clone()
            nconn = nw.conns[ccid]
            resp = nconn.resp[0]
            nconn.resp = nconn.resp[1:]
            _client_consume(nw, nw.clients[cid], sid, resp, spec, sc)
            yield (f"c{cid}: recv {resp.intent} reply from s{sid} "
                   f"({OP_NAMES.get(resp.op, resp.op)})", nw)
        # timeout: only when no progress is possible on a slice's
        # connection — dead socket, retired rank, or (for a delivered
        # push, whose outcome is then unknown) a partitioned rank.  An
        # idempotent op under a pure partition just waits: the real
        # client's reconnect would be refused and burn backoff until
        # the window heals, observably equivalent to the late reply.
        kind, ident, slices = cl.op
        for sid, st in sorted(slices.items()):
            if st not in ("sent", "unsent"):
                continue
            conn = w.conns.get(cl.conns.get(sid, -1))
            dead = conn is None or not conn.alive
            stalled = (conn is not None and conn.server in w.servers
                       and w.servers[conn.server].partitioned)
            retired = sid not in w.servers or not w.servers[sid].alive
            if not (dead or retired
                    or (stalled and kind == "push" and st == "sent")):
                continue
            nw = w.clone()
            yield (_client_timeout(nw, nw.clients[cid], sid, sc, spec), nw)
            break  # one timeout action per state is enough (same ladder)
    # --- servers ---
    for sid, srv in sorted(w.servers.items()):
        if not srv.alive:
            continue
        for ccid, conn in sorted(w.conns.items()):
            if conn.server != sid:
                continue
            if (conn.req and not srv.partitioned and not conn.delayed):
                nw = w.clone()
                nsrv, nconn = nw.servers[sid], nw.conns[ccid]
                req = nconn.req[0]
                nconn.req = nconn.req[1:]
                nconn.delivered += 1
                _reply(nw, nsrv, nconn, req, spec, sc.num_workers)
                yield (f"s{sid}: process {OP_NAMES[req.op]}"
                       f"{f' {req.push}' if req.push else ''} "
                       f"(conn {ccid})", nw)
            if not conn.alive and not conn.drop_done:
                # DropConnection: roll back this connection's unreleased
                # barrier votes (the reader thread noticing EOF) — the
                # action whose RACE with a re-vote the barrier dedup closed
                nw = w.clone()
                nsrv, nconn = nw.servers[sid], nw.conns[ccid]
                nconn.drop_done = True
                for gen in list(nsrv.barrier):
                    nsrv.barrier[gen] = tuple(
                        (c, vc) for c, vc in nsrv.barrier[gen]
                        if vc != ccid)
                    if not nsrv.barrier[gen]:
                        del nsrv.barrier[gen]
                yield (f"s{sid}: drop conn {ccid} (roll back its "
                       "barrier votes)", nw)
    # --- faults (chaos alphabet, budgeted) ---
    if w.faults_left > 0:
        yield from _fault_actions(w, sc)
    for sid, srv in sorted(w.servers.items()):
        if srv.partitioned:
            nw = w.clone()
            nw.servers[sid].partitioned = False
            yield (f"fault: heal partition of s{sid}", nw)
    for ccid, conn in sorted(w.conns.items()):
        if conn.delayed:
            nw = w.clone()
            nw.conns[ccid].delayed = False
            yield (f"fault: release delayed conn {ccid}", nw)
    # --- coordinator (one scripted resize) ---
    if sc.resize is not None:
        yield from _coord_actions(w, sc, spec)


def _client_timeout(w: World, cl: ClientS, sid: int, sc: Scenario,
                    spec: Spec) -> str:
    """The retry ladder on a receive timeout / dead socket, per
    :meth:`distlr_tpu_torch.ps.client.KVWorker._run_with_retry`:

    * idempotent ops (pull, barrier): reconnect in place and re-issue —
      the server rolls a dead connection's votes back, so a re-issue
      counts once;
    * a push slice whose delivery BEGAN: outcome unknown — absorbed
      (counted, never re-issued: a maybe-applied push re-issued is a
      silent double-apply).  If the rank is RETIRED (resharded away),
      recovery is the membership layer: enter reroute;
    * a push slice never delivered (``unsent``): safe to re-issue.
    """
    kind, ident, slices = cl.op
    retired = sid not in w.servers or not w.servers[sid].alive
    if retired and kind == "push" and slices.get(sid) == "sent":
        if spec.absorb_fenced_push:
            # delivered against a rank the layout retired: the
            # membership-layer absorption (outcome unknown)
            slices[sid] = "unknown"
            cl.absorbed = cl.absorbed + (ident,)
            if any(st == "unsent" for st in slices.values()):
                cl.op = ("reroute", kind, ident)
            else:
                _finish_op_if_resolved(cl)
            return (f"c{cl.cid}: timeout on retired s{sid} — push {ident} "
                    "absorbed as outcome-unknown")
        cl.op = ("reroute", kind, ident)
        return (f"c{cl.cid}: timeout on retired s{sid} — will re-route "
                f"and RE-ISSUE push {ident} (mutant)")
    if retired:
        cl.op = ("reroute", kind, ident)
        return (f"c{cl.cid}: timeout on retired s{sid} — re-route "
                f"{kind} {ident}")
    if kind == "push" and slices.get(sid) == "sent":
        # transport fault after delivery began: unknown-outcome, absorbed
        slices[sid] = "unknown"
        cl.absorbed = cl.absorbed + (ident,)
        _finish_op_if_resolved(cl)
        return (f"c{cl.cid}: timeout on s{sid} — push {ident} slice "
                "absorbed as outcome-unknown (delivery began)")
    # idempotent (or never-delivered push slice): reconnect + re-issue
    srv = w.servers[sid]
    old = cl.conns.get(sid)
    if old is not None and old in w.conns:
        w.conns[old].alive = False
    announce = cl.layout_epoch if srv.caps & wire.CAP_EPOCH else 0
    conn = ConnS(w.next_conn, cl.cid, sid, announce)
    w.next_conn += 1
    w.conns[conn.cid] = conn
    cl.conns[sid] = conn.cid
    if kind == "barrier":
        conn.req = conn.req + (
            Req(wire.OP_BARRIER, ident, cl.cid, None, (), wire.CODEC_NONE),)
        slices[sid] = "sent"
        return (f"c{cl.cid}: timeout — reconnect s{sid} (conn "
                f"{conn.cid}) and re-vote barrier gen {ident}")
    coords = _owners(w, cl, w.issued[ident]).get(sid, ())
    op = wire.OP_PUSH if kind == "push" else wire.OP_PULL
    conn.req = conn.req + (
        Req(op, 0, cl.cid, ident, coords, cl.codec if kind == "push"
            else wire.CODEC_NONE),)
    slices[sid] = "sent"
    return (f"c{cl.cid}: timeout — reconnect s{sid} (conn {conn.cid}) "
            f"and re-issue {kind} {ident} slice")


def _client_reroute(w: World, cl: ClientS, sc: Scenario,
                    spec: Spec) -> str:
    """Complete a fence/retirement recovery once the coordinator is
    ACTIVE: re-fetch the layout, rebuild + renegotiate every
    connection, then resolve the interrupted op — idempotent ops
    re-issue; pushes are absorbed as outcome-unknown (the fix) or
    re-issued (the reverted mutant, a double-apply)."""
    _phase, kind, ident = cl.op
    cl.layout = tuple((s.sid, s.lo, s.hi)
                      for _, s in sorted(w.servers.items()) if s.alive)
    cl.layout_epoch = w.coord.epoch
    cl.conns = {}
    if not _connect(w, cl, sc):
        return f"c{cl.cid}: re-route blocked (target partitioned)"
    if kind == "push":
        if spec.absorb_fenced_push:
            cl.absorbed = cl.absorbed + (ident,)
            cl.op = None
            cl.pc += 1
            return (f"c{cl.cid}: re-route to epoch {cl.layout_epoch} — "
                    f"push {ident} absorbed as outcome-unknown "
                    "(fence straddle)")
        _enqueue_slices(w, cl, kind, ident, w.issued[ident])
        return (f"c{cl.cid}: re-route to epoch {cl.layout_epoch} — "
                f"RE-ISSUED push {ident} (mutant)")
    if kind == "barrier":
        _enqueue_slices(w, cl, kind, ident, ())
        return (f"c{cl.cid}: re-route to epoch {cl.layout_epoch} — "
                f"re-vote barrier gen {ident}")
    _enqueue_slices(w, cl, kind, ident, w.issued.get(ident, ()))
    return (f"c{cl.cid}: re-route to epoch {cl.layout_epoch} — "
            f"re-issue {kind} {ident}")


def _fault_actions(w: World, sc: Scenario):
    """The chaos fault alphabet (:mod:`distlr_tpu_torch.chaos.plan`), one
    budgeted injection: ``reset`` severs a connection AFTER a delivered
    frame (its reply is already unreachable — the push-outcome-unknown
    case), ``reset_mid`` cuts the tail frame mid-stream (RST: the
    server drops it, bytes DID leave the client), ``delay`` stalls a
    stream, ``partition`` stalls a whole rank."""
    for ccid, conn in sorted(w.conns.items()):
        if not conn.alive:
            continue
        if "reset" in sc.faults and (conn.req or conn.resp
                                     or conn.delivered):
            nw = w.clone()
            nc = nw.conns[ccid]
            nc.alive = False
            nc.resp = ()   # replies severed; delivered reqs stand
            nw.faults_left -= 1
            yield (f"fault: reset conn {ccid} after delivery "
                   "(replies severed)", nw)
        if "reset_mid" in sc.faults and conn.req:
            nw = w.clone()
            nc = nw.conns[ccid]
            dropped = nc.req[-1]
            nc.req = nc.req[:-1]   # mid-frame RST: server drops the cut frame
            nc.resp = ()
            nc.alive = False
            nw.faults_left -= 1
            yield (f"fault: reset conn {ccid} mid-frame (drops "
                   f"{OP_NAMES[dropped.op]})", nw)
        if "delay" in sc.faults and conn.req and not conn.delayed:
            nw = w.clone()
            nw.conns[ccid].delayed = True
            nw.faults_left -= 1
            yield f"fault: delay conn {ccid} (stream stalled)", nw
    if "partition" in sc.faults:
        for sid, srv in sorted(w.servers.items()):
            if srv.alive and not srv.partitioned:
                nw = w.clone()
                nw.servers[sid].partitioned = True
                nw.faults_left -= 1
                yield f"fault: partition s{sid}", nw


def _coord_actions(w: World, sc: Scenario, spec: Spec):
    """The one scripted live resize, staged exactly like
    :meth:`distlr_tpu_torch.ps.membership.MembershipCoordinator.resize`:
    spawn (new ranks at the next epoch) -> fence (per rank — the
    interleavings AROUND the flip are the whole point) -> drain (per
    moved sub-range; copies the z/n multiset) -> commit+activate."""
    co = w.coord
    if co.phase == "idle":
        nw = w.clone()
        nco = nw.coord
        nco.phase = "begun"
        # the real resize() flips its published status to "migrating"
        # under the lock before anything else — clients poll from here
        nco.pub_status = "migrating"
        nco.target = sc.resize
        nco.new_ranges = split_ranges(sc.dim, sc.resize)
        old = {s.sid: (s.lo, s.hi) for s in nw.servers.values() if s.alive}
        nco.reuse = {nr: sid for nr, (lo, hi) in enumerate(nco.new_ranges)
                     for sid, (olo, _ohi) in old.items() if olo == lo}
        moves = []
        for sid, (olo, ohi) in sorted(old.items()):
            for nr, (nlo, nhi) in enumerate(nco.new_ranges):
                mlo, mhi = max(olo, nlo), min(ohi, nhi)
                if mhi <= mlo:
                    continue
                if nco.reuse.get(nr) == sid:
                    continue  # resident slice never crosses the wire
                moves.append((sid, mlo, mhi, nr))
        nco.moves = tuple(moves)
        # spawn: new ranks at the NEXT epoch (fresh sids above the max)
        next_sid = max(nw.servers) + 1
        for nr in range(sc.resize):
            if nr not in nco.reuse:
                lo, hi = nco.new_ranges[nr]
                srv = ServerS(next_sid, lo, hi, co.epoch + 1,
                              sc.caps_of(next_sid))
                nw.servers[next_sid] = srv
                nco.reuse[nr] = next_sid   # resolved rank -> sid mapping
                next_sid += 1
        yield (f"coord: begin resize -> {sc.resize} rank(s), spawn at "
               f"epoch {co.epoch + 1}; layout now MIGRATING", nw)
        return
    if co.phase == "begun":
        for sid, srv in sorted(w.servers.items()):
            # old ranks are the ones still at the published epoch
            # (spawned ranks start life at epoch+1, already "fenced")
            if srv.alive and sid not in co.fenced and srv.epoch == co.epoch:
                nw = w.clone()
                nw.servers[sid].epoch = co.epoch + 1
                nw.coord.fenced = nw.coord.fenced | {sid}
                if _all_old_fenced(nw.coord, nw.servers):
                    nw.coord.phase = "fenced"
                yield (f"coord: fence s{sid} at epoch {co.epoch + 1} "
                       "(admin kEpoch SET)", nw)
        return
    if co.phase == "fenced":
        for i, (sid, mlo, mhi, nr) in enumerate(co.moves):
            if i in co.drained:
                continue
            nw = w.clone()
            nco = nw.coord
            dst = nw.servers[nco.reuse[nr]]
            src = nw.servers[sid]
            for k in range(mlo, mhi):
                if k in src.zn:
                    dst.zn[k] = src.zn[k]
            nco.drained = nco.drained | {i}
            if len(nco.drained) == len(nco.moves):
                nco.phase = "drained"
            yield (f"coord: drain [{mlo},{mhi}) s{sid} -> "
                   f"s{nco.reuse[nr]} (keyed pull + forced init-push)",
                   nw)
        if not co.moves:
            nw = w.clone()
            nw.coord.phase = "drained"
            yield "coord: nothing to drain", nw
        return
    if co.phase == "drained":
        nw = w.clone()
        nco = nw.coord
        keep = set(nco.reuse.values())
        for nr, (lo, hi) in enumerate(nco.new_ranges):
            srv = nw.servers[nco.reuse[nr]]
            srv.lo, srv.hi = lo, hi
            srv.zn = {k: v for k, v in srv.zn.items() if lo <= k < hi}
            srv.epoch = nco.epoch + 1
        for sid, srv in nw.servers.items():
            if srv.alive and sid not in keep:
                srv.alive = False       # retired rank: process exits,
                for conn in nw.conns.values():  # its sockets die
                    if conn.server == sid:
                        conn.alive = False
        nco.epoch += 1
        nco.phase = "done"
        nco.pub_status = "active"
        _check_zn_preserved(nw, sc)
        yield (f"coord: commit + activate epoch {nco.epoch} "
               f"({len(keep)} rank(s))", nw)


def _all_old_fenced(co: CoordS, servers: dict) -> bool:
    for sid, srv in servers.items():
        if srv.alive and srv.epoch == co.epoch:
            return False
    return True


def _check_zn_preserved(w: World, sc: Scenario):
    """I5 (FTRL scenarios): after activate, every coordinate's z/n
    multiset at its NEW owner equals the multiset of pushes actually
    applied to it — a drain that lost, duplicated, or mis-ranged an
    accumulator shows up as a mismatch."""
    if sc.optimizer != "ftrl":
        return
    for srv in w.servers.values():
        if not srv.alive:
            continue
        for k in range(srv.lo, srv.hi):
            have = tuple(sorted(srv.zn.get(k, ())))
            want = tuple(sorted(
                p for (p, kk), n in w.applied.items()
                if kk == k for _ in range(n)))
            if have != want:
                w.violation = (
                    f"I5: FTRL z/n lost by migration at coord {k} of "
                    f"rank s{srv.sid}: accumulator holds {have} but "
                    f"applied history says {want}")
                return


def world_invariant(w: World, sc: Scenario) -> str | None:
    """State invariants re-checked by the checker at every node (the
    action-time checks set ``violation`` eagerly; this is the safety
    net for anything state-shaped): applied <= issued, per-coordinate."""
    if w.violation:
        return w.violation
    for (push, coord), n in w.applied.items():
        if n > 1:
            return f"I1: push {push} applied {n}x to coord {coord}"
        if push not in w.issued or coord not in w.issued[push]:
            return (f"I1: applied ({push}, {coord}) was never issued "
                    "for that coordinate")
    return None
