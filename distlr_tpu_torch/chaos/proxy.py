"""Deterministic TCP fault-injection proxy for the native KV protocol (the
port's copy of ``distlr_tpu/chaos/proxy.py``).

One :class:`ChaosLink` is a listening socket in front of ONE upstream
server rank; a :class:`ChaosFabric` is the set of links fronting a
whole server group, exposing a drop-in ``hosts`` string — point any
:class:`~distlr_tpu_torch.ps.KVWorker` / ``LivePSWatcher`` at it and every
byte of KV traffic flows through the fault plan
(:mod:`distlr_tpu_torch.chaos.plan`): packet delay and jitter, slow links,
connection resets mid-op, full/partial partitions — and ``kill``
process faults (SIGKILL of a server rank or the whole
group at a deterministic op offset or clock offset, the durability
suite's power-loss primitive; executed via the fabric's ``killer``
callback since the proxy itself holds no pids).

Mechanics per link:

* the client->server stream is FRAMED — the proxy parses each
  ``MsgHeader`` (kv_protocol.h: 24 bytes, then ``num_keys`` u64 keys,
  then vals for push-class ops) so fault offsets are stated in OPS, the
  unit retry semantics care about; the server->client stream is relayed
  raw (responses are only ever delayed/stalled/severed, never reframed);
* ``delay`` sleeps each request frame ``delay_ms ± jitter_ms``, the
  jitter drawn as a pure hash of ``(seed, link, fault, op_index)`` —
  thread interleaving cannot perturb the timeline;
* ``throttle`` paces both directions to ``bytes_per_sec``;
* ``reset`` with ``after_ops=N`` delivers frame N upstream, then severs
  the connection BEFORE its response can relay (the
  push-outcome-unknown case the client's RetryPolicy must not retry);
  with ``after_bytes=M`` it hard-kills (RST, queued data discarded)
  once M cumulative client bytes have been forwarded — a mid-frame cut
  the server drops without applying;
* ``partition`` stalls established connections (bytes neither lost nor
  forwarded — TCP semantics of a real partition) and refuses new ones
  for the window's duration;
* ``kill`` fires ONCE per fault: after frame ``after_ops`` has been
  forwarded on an observing link (a power cut with the triggering push
  delivered but not necessarily applied — exactly the torn state the
  durable store must recover from) or when the fabric clock reaches
  ``at_s``; the event records the plan offset, never wall time.

Every injected fault is counted on the fabric (:attr:`ChaosFabric.counters`)
and in the JAX package's ``distlr_chaos_*`` registry series, and recorded
in a wall-clock-free event
log: offsets, plan windows, and hash-derived delays only, so two runs of
the same seed + plan + client op sequence produce byte-identical logs
(:meth:`ChaosFabric.events`); :attr:`ChaosFabric.timeline` keeps the same
events with their wall-clock times.
"""

from __future__ import annotations

import hashlib
import socket
import struct

from distlr_tpu_torch import sync
from distlr_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from distlr_tpu_torch.compress import codecs
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.ps import wire
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: the fabric's counters (the JAX package's ``distlr_chaos_*`` series):
#: ``faults`` by (kind, link) (delay per delayed frame, reset per severed
#: connection, partition per window activation, partition_refused per
#: refused connect, throttle per paced window activation, kill per
#: SIGKILLed target), ``ops_forwarded`` by link (client->server KV frames),
#: ``bytes`` by (link, direction) and ``delay_ms`` by link
COUNTERS = ("faults", "ops_forwarded", "bytes", "delay_ms")

_reg = get_registry()
_FAULTS = _reg.counter(
    "distlr_chaos_faults_total",
    "faults injected by the chaos proxy, by kind "
    "(delay per delayed frame, reset per severed connection, partition "
    "per window activation, partition_refused per refused connect, "
    "throttle per paced window activation, kill per SIGKILLed target)",
    labelnames=("kind", "link"),
)
_OPS = _reg.counter(
    "distlr_chaos_ops_forwarded_total",
    "client->server KV frames forwarded through the chaos proxy",
    labelnames=("link",),
)
_BYTES = _reg.counter(
    "distlr_chaos_bytes_total",
    "bytes relayed through the chaos proxy",
    labelnames=("link", "direction"),
)
_DELAY_MS = _reg.counter(
    "distlr_chaos_delay_ms_total",
    "injected request-frame delay, milliseconds",
    labelnames=("link",),
)
#: each counter's registry family and its labels from a counter key
_SERIES = {
    "faults": (_FAULTS, lambda key: {"kind": key[0], "link": str(key[1])}),
    "ops_forwarded": (_OPS, lambda key: {"link": str(key)}),
    "bytes": (_BYTES, lambda key: {"link": str(key[0]), "direction": key[1]}),
    "delay_ms": (_DELAY_MS, lambda key: {"link": str(key)}),
}

#: MsgHeader framing, op codes, and the flags bits the parser depends
#: on — all from the one Python mirror of kv_protocol.h
#: (:mod:`distlr_tpu_torch.ps.wire`): bits
#: 4-5 carry the gradient codec of a push-class value payload, bit 6
#: marks an opt-state op (2x vals per key), bit 7 a 16-byte trace
#: trailer after the header (whose trace_id the fault events record —
#: "this retry was caused by fault #3" readable straight off the
#: merged trace)
_HEADER = wire.HEADER_STRUCT
_MAGIC = wire.MAGIC
_OP_PUSH, _OP_PUSHPULL = wire.OP_PUSH, wire.OP_PUSH_PULL
_OPT_STATE, _TRACED = wire.FLAG_OPT_STATE, wire.FLAG_TRACED
_TRACE_FRAME = wire.TRACE_FRAME_STRUCT
_OP_HELLO = wire.OP_HELLO
_CODEC_NAMES = {v: k for k, v in codecs.CODEC_IDS.items()}


def _push_vals_bytes(flags: int, n_flat: int) -> int:
    """Value-payload bytes of a push-class frame carrying ``n_flat``
    expanded values — codec-aware via the shared
    :func:`distlr_tpu_torch.compress.codecs.payload_bytes` (one definition of
    the byte layout next to the native CodecPayloadBytes): a proxy that
    assumed dense f32 would misframe every compressed push and degrade
    the whole stream to a raw relay, silently disabling op-offset
    faults for exactly the runs the compression bench needs them on."""
    codec = _CODEC_NAMES.get(wire.codec_of(flags), "none")
    mult = 2 if codec == "none" and flags & _OPT_STATE else 1
    return codecs.payload_bytes(codec, n_flat) * mult
#: pump socket timeout: bounds stop() latency without busy-waiting
_TICK_S = 0.1
#: event-log cap — a runaway plan must not grow memory unboundedly
_MAX_EVENTS = 100_000

#: canonical event-log SCHEMA version (the ``launch chaos
#: --events-path`` file format), the JAX package's: replay tooling can
#: refuse an unrecognized log instead of silently misparsing it.
#: Schema 1 document shape:
#:   {"schema": 1, "seed": <plan seed>, "truncated": <bool>,
#:    "events": [[link, kind, {detail}], ...]}
EVENT_SCHEMA = 1


def load_events_doc(path: str) -> dict:
    """Read a canonical event log back, REJECTING unknown schemas
    loudly: a replayer guessing at an old or future format would
    vacuously 'conform'.  Raises :class:`ValueError` on a headerless
    (pre-pinning) or mismatched-schema file."""
    import json  # noqa: PLC0415 — only replay tooling pays for it

    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "schema" not in doc:
        raise ValueError(
            f"{path}: chaos event log has no schema header (pre-pinning "
            f"format?) — this reader speaks schema {EVENT_SCHEMA} only")
    if doc["schema"] != EVENT_SCHEMA:
        raise ValueError(
            f"{path}: chaos event log schema {doc['schema']!r} != the "
            f"pinned {EVENT_SCHEMA} — refusing to misparse")
    return doc


def _unit(seed: int, *parts) -> float:
    """Deterministic uniform draw in [0, 1) from a hash of the
    coordinates — NOT a shared RNG stream, so concurrent links/ops
    cannot perturb each other's draws."""
    digest = hashlib.blake2b(repr((seed, parts)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") / 2.0 ** 64


class _Severed(Exception):
    """Internal: this connection was reset by a fault."""


class ChaosLink:
    """Fault-injecting proxy for one client->server link.

    ``protocol`` selects the client->server framing: ``"kv"`` (the
    native MsgHeader framing — PS links) or ``"serve"`` (the serving
    tier's newline-delimited line protocol — router/engine links: one
    request LINE is one op, so ``after_ops``
    reset faults and per-op delays mean the same thing to a routed
    scoring request that they mean to a KV push, and router failover /
    rollout-rollback claims get the same adversarial treatment the PS
    client got)."""

    def __init__(self, link: int, upstream: tuple[str, int],
                 plan: FaultPlan, fabric: "ChaosFabric", *,
                 protocol: str = "kv"):
        if protocol not in ("kv", "serve"):
            raise ValueError(f"protocol must be kv|serve, got {protocol!r}")
        self.link = link
        self.upstream = upstream
        self.protocol = protocol
        self._plan = plan
        self._fabric = fabric
        self._delay_faults = plan.for_link(link, "delay")
        self._throttle_faults = plan.for_link(link, "throttle")
        self._reset_faults = plan.for_link(link, "reset")
        self._partition_faults = plan.for_link(link, "partition")
        # op-offset kills observed from this link (time-triggered kills
        # live on the fabric's clock thread, not any link)
        self._kill_faults = tuple(f for f in plan.for_link(link, "kill")
                                  if f.after_ops is not None)
        self._lock = sync.Lock()
        # cumulative per-LINK traffic state (across reconnects), so
        # after_ops/after_bytes offsets mean "the Nth op/byte on this
        # link", not "on this connection"
        self._ops = 0
        self._bytes_c2s = 0
        self._fired: set[int] = set()      # one-shot reset fault indices
        self._announced: set[tuple] = set()  # (fault, window) activations
        self._threads: list[sync.Thread] = []
        self._stop = sync.Event()
        self._lsock = self._listen()
        self.port = self._lsock.getsockname()[1]
        self._accept_thread = sync.Thread(
            target=self._accept_loop, daemon=True,
            name=f"chaos-accept-{link}")
        self._accept_thread.start()

    # -- endpoints --------------------------------------------------------
    def _listen(self) -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(64)
        s.settimeout(_TICK_S)
        return s

    def _connect_upstream(self) -> socket.socket:
        return socket.create_connection(self.upstream, timeout=5.0)

    # -- fault predicates -------------------------------------------------
    def _now(self) -> float:
        return self._fabric.now()

    def _partition_active(self) -> FaultSpec | None:
        t = self._now()
        for f in self._partition_faults:
            if f.active_at(t):
                return f
        return None

    def _announce(self, f: FaultSpec, kind: str) -> None:
        """Record a windowed fault's activation ONCE per (fault, window)
        — the event log carries the PLAN's window, never wall time."""
        key = (f.index, f.window)
        with self._lock:
            if key in self._announced:
                return
            self._announced.add(key)
        self._fabric.record(self.link, kind, fault=f.index, window=f.window)
        self._fabric.count("faults", (kind, self.link))

    # -- accept / pump loops ----------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                down, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            part = self._partition_active()
            if part is not None:
                # a partitioned host REFUSES new connects fast
                # (RST-style — the accepted socket closes immediately),
                # so a client's reconnect loop burns backoff, not a full
                # connect timeout; size retry budgets on backoff-sum >=
                # window.  Count it, but keep it out of the
                # deterministic event log — reconnect-attempt counts are
                # timing-dependent
                self._announce(part, "partition")
                self._fabric.count("faults", ("partition_refused", self.link))
                down.close()
                continue
            try:
                up = self._connect_upstream()
            except OSError:
                down.close()
                continue
            for s in (down, up):
                s.settimeout(_TICK_S)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            severed = sync.Event()
            # the two pumps' exit tokens: the one that pops 0 is the last
            # out and closes the sockets (:meth:`_leave`)
            left = [0, 1]
            t1 = sync.Thread(target=self._pump_c2s,
                             args=(down, up, severed, left), daemon=True,
                             name=f"chaos-c2s-{self.link}")
            t2 = sync.Thread(target=self._pump_s2c,
                             args=(down, up, severed, left), daemon=True,
                             name=f"chaos-s2c-{self.link}")
            with self._lock:
                # prune finished churn: a reset-heavy plan forces a
                # reconnect (fresh conn + 2 pump threads) per reset, and
                # a soak must not hoard every dead thread
                self._threads = [t for t in self._threads
                                 if t.is_alive()] + [t1, t2]
            t1.start()
            t2.start()

    def _read_exact(self, sock: socket.socket, n: int,
                    severed: sync.Event) -> bytes | None:
        buf = b""
        while len(buf) < n:
            if self._stop.is_set() or severed.is_set():
                return None
            try:
                chunk = sock.recv(n - len(buf))
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _stall_while_partitioned(self, severed: sync.Event) -> None:
        while not (self._stop.is_set() or severed.is_set()):
            part = self._partition_active()
            if part is None:
                return
            self._announce(part, "partition")
            sync.sleep(min(_TICK_S, 0.02))

    def _throttle(self, nbytes: int, severed: sync.Event) -> None:
        t = self._now()
        for f in self._throttle_faults:
            if f.active_at(t):
                self._announce(f, "throttle")
                pause = nbytes / f.bytes_per_sec
                end = sync.monotonic() + pause
                while (sync.monotonic() < end
                       and not (self._stop.is_set() or severed.is_set())):
                    # re-read the clock for the sleep arg: the deadline
                    # can pass between the while-check and here, and a
                    # negative sleep raises, killing the pump thread
                    # (observed as a spurious severed link under a
                    # high-rate throttle)
                    sync.sleep(min(_TICK_S, max(0.0, end - sync.monotonic())))
                return

    def _sever(self, down: socket.socket, up: socket.socket,
               severed: sync.Event, *, hard: bool) -> None:
        """End the connection: both pumps stop, and the close
        (:meth:`_leave`) follows as soon as the s2c pump is out of its
        read — within one tick, since the c2s pump wakes it."""
        severed.set()
        if hard:
            # RST both ways: queued bytes are DISCARDED (the mid-frame
            # cut; the server drops the incomplete frame on close)
            for s in (down, up):
                try:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
                except OSError:
                    pass

    @staticmethod
    def _leave(down: socket.socket, up: socket.socket, wake: socket.socket,
               left: list) -> None:
        """A pump's exit from its connection.  It wakes the other pump out
        of its read on ``wake`` (``shutdown(SHUT_RD)`` puts nothing on the
        wire, and is a use of the descriptor, not its end), then takes its
        exit token: the pump that takes the last one (0) closes both
        sockets.  So each socket has exactly one closing thread, and the
        close comes after the other pump's last call on it: a close while
        the other pump sits in ``recv`` is a data race on the descriptor.
        ``list.pop`` is atomic under the GIL."""
        try:
            wake.shutdown(socket.SHUT_RD)
        except OSError:
            pass
        if left.pop() != 0:
            return
        for s in (down, up):
            try:
                s.close()
            except OSError:
                pass

    def _read_line_frame(self, sock: socket.socket,
                         severed: sync.Event,
                         buf: bytearray) -> bytes | None:
        """One serve-protocol frame: a newline-terminated request line
        (newline included — byte offsets stay exact).  ``buf`` holds
        the cross-read remainder."""
        while True:
            i = buf.find(b"\n")
            if i >= 0:
                frame = bytes(buf[:i + 1])
                del buf[:i + 1]
                return frame
            if self._stop.is_set() or severed.is_set():
                return None
            try:
                chunk = sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None  # EOF mid-line: no newline = no request
            buf += chunk

    @staticmethod
    def _line_trace_id(frame: bytes) -> int | None:
        """trace_id of a ``TRACE <tid>/<sid> ...`` serve line (the
        router's additive prefix), None when untraced/unparseable."""
        if not frame.startswith(b"TRACE "):
            return None
        parts = frame.split(b" ", 2)
        if len(parts) < 3:
            return None
        tid = parts[1].split(b"/", 1)[0]
        try:
            return int(tid, 16)
        except ValueError:
            return None

    def _pump_c2s(self, down: socket.socket, up: socket.socket,
                  severed: sync.Event, left: list) -> None:
        """Framed client->server pump — all op-offset faults live here."""
        link = str(self.link)
        linebuf = bytearray()  # serve-protocol cross-read remainder
        try:
            while not (self._stop.is_set() or severed.is_set()):
                if self.protocol == "serve":
                    frame = self._read_line_frame(down, severed, linebuf)
                    if frame is None:
                        break
                    tid = self._line_trace_id(frame)
                    trace_kv = ({"trace": f"{tid:016x}"}
                                if tid is not None else {})
                else:
                    header = self._read_exact(down, _HEADER.size, severed)
                    if header is None:
                        break
                    magic, op, flags, aux, _cid, _ts, num_keys = \
                        _HEADER.unpack(header)
                    if magic != _MAGIC:
                        # not KV framing (or stream corrupted upstream of
                        # us): degrade to a raw relay for this connection
                        log.warning(
                            "chaos link %s: non-KV frame; relaying raw",
                            link)
                        up.sendall(header)
                        self._relay_raw(down, up, severed)
                        break
                    # trace trailer (kv_protocol.h kTraced): 16 bytes
                    # after the header on every op but kHello (whose flag
                    # only asks for a clock in the reply) — misframing it
                    # would degrade the whole stream to a raw relay,
                    # silently disabling op-offset faults for exactly the
                    # traced runs
                    trailer = b""
                    trace_id = None
                    if flags & _TRACED and op != _OP_HELLO:
                        trailer = self._read_exact(down, _TRACE_FRAME.size,
                                                   severed)
                        if trailer is None:
                            break
                        trace_id = _TRACE_FRAME.unpack(trailer)[0]
                    trace_kv = ({"trace": f"{trace_id:016x}"}
                                if trace_id is not None else {})
                    vpk = (max(aux, 1)
                           if op in (_OP_PUSH, _OP_PUSHPULL) else 1)
                    payload_len = num_keys * 8
                    if op in (_OP_PUSH, _OP_PUSHPULL):
                        payload_len += _push_vals_bytes(flags,
                                                        num_keys * vpk)
                    payload = b""
                    if payload_len:
                        payload = self._read_exact(down, payload_len,
                                                   severed)
                        if payload is None:
                            break
                    frame = header + trailer + payload

                self._stall_while_partitioned(severed)
                if self._stop.is_set() or severed.is_set():
                    break
                # Atomically CLAIM this frame's op index + byte span and
                # decide any one-shot reset, all under the link lock —
                # several connections pump one link concurrently (every
                # worker plus its push-clock probe), and a check-then-act
                # here would double-fire one-shot resets, hand two frames
                # the same jitter draw, and overrun after_bytes.
                cut_reset = None      # (fault, bytes of frame to deliver)
                after_reset = None    # fault: deliver frame, sever reply
                with self._lock:
                    op_index = self._ops  # 0-based index of THIS frame
                    self._ops += 1
                    byte_start = self._bytes_c2s
                    self._bytes_c2s += len(frame)
                    for f in self._reset_faults:
                        if f.index in self._fired:
                            continue
                        if (f.after_bytes is not None
                                and byte_start + len(frame) > f.after_bytes):
                            self._fired.add(f.index)
                            cut_reset = (f, max(0, f.after_bytes - byte_start))
                            break
                        if (f.after_ops is not None
                                and op_index + 1 >= f.after_ops):
                            self._fired.add(f.index)
                            after_reset = f
                            break

                # delay: deterministic per (seed, link, fault, op)
                t = self._now()
                for f in self._delay_faults:
                    if not f.active_at(t):
                        continue
                    ms = f.delay_ms
                    if f.jitter_ms:
                        u = _unit(self._plan.seed, self.link, f.index,
                                  op_index)
                        ms += f.jitter_ms * (2.0 * u - 1.0)
                    self._fabric.record(self.link, "delay", fault=f.index,
                                        op=op_index, ms=round(ms, 3),
                                        **trace_kv)
                    self._fabric.count("faults", ("delay", self.link))
                    self._fabric.count("delay_ms", self.link, ms)
                    # sliced like the stall/throttle waits: a multi-second
                    # delay must not outlive stop()'s thread joins
                    end = sync.monotonic() + ms / 1000.0
                    while (sync.monotonic() < end
                           and not (self._stop.is_set()
                                    or severed.is_set())):
                        # same clamp as the throttle loop: the deadline
                        # can pass between the while-check and here, and
                        # a negative sleep raises, killing the pump
                        sync.sleep(min(_TICK_S,
                                       max(0.0, end - sync.monotonic())))

                # reset at byte offset: forward only up to the offset,
                # then hard-kill mid-frame (frame NOT delivered)
                if cut_reset is not None:
                    f, cut = cut_reset
                    if cut > 0:
                        try:
                            up.sendall(frame[:cut])
                        except OSError:
                            pass
                    self._fabric.record(self.link, "reset", fault=f.index,
                                        byte=f.after_bytes, **trace_kv)
                    self._fabric.count("faults", ("reset", self.link))
                    self._sever(down, up, severed, hard=True)
                    return

                # pace BEFORE forwarding: a throttled link slows the op
                # itself, not just its successors
                self._throttle(len(frame), severed)
                if after_reset is not None:
                    # sever the REPLY path before the request can even
                    # reach the server: the s2c pump checks this flag
                    # before forwarding, so the response of a delivered
                    # frame can never win a race back to the client —
                    # the push-outcome-unknown contract is airtight
                    severed.set()
                try:
                    up.sendall(frame)
                except OSError:
                    break
                self._fabric.count("ops_forwarded", self.link)
                self._fabric.count("bytes", (self.link, "c2s"), len(frame))

                # kill at op offset: frame N was DELIVERED, then the
                # target loses power — applied-or-not is exactly the
                # ambiguity the durable store's recovery must absorb.
                # One-shot fabric-wide (fire_kill claims the index); the
                # plan pins ONE observing link so the event log stays
                # deterministic.
                for f in self._kill_faults:
                    if op_index + 1 >= f.after_ops:
                        self._fabric.fire_kill(f, self.link,
                                               op=f.after_ops, **trace_kv)

                # reset at op offset: frame N was DELIVERED (sendall
                # above, graceful upstream close below flushes it), but
                # its response is already unreachable
                if after_reset is not None:
                    self._fabric.record(self.link, "reset",
                                        fault=after_reset.index,
                                        op=after_reset.after_ops,
                                        **trace_kv)
                    self._fabric.count("faults", ("reset", self.link))
                    self._sever(down, up, severed, hard=False)
                    return
        finally:
            severed.set()
            self._leave(down, up, up, left)

    def _relay_raw(self, down: socket.socket, up: socket.socket,
                   severed: sync.Event) -> None:
        while not (self._stop.is_set() or severed.is_set()):
            try:
                chunk = down.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            try:
                up.sendall(chunk)
            except OSError:
                return

    def _pump_s2c(self, down: socket.socket, up: socket.socket,
                  severed: sync.Event, left: list) -> None:
        """Raw server->client relay: responses are delayed only by
        stalls/throttle, never reframed.

        On upstream EOF/error this pump SETS ``severed`` and leaves; it
        closes the sockets only as the last pump out (:meth:`_leave`),
        so it can never cut the after_ops reset's
        set-severed-then-deliver-frame-N sequence short (losing both the
        delivery and the recorded reset event): the c2s pump is still in
        it, holding its token."""
        try:
            while not (self._stop.is_set() or severed.is_set()):
                try:
                    chunk = up.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                self._stall_while_partitioned(severed)
                self._throttle(len(chunk), severed)
                if severed.is_set() or self._stop.is_set():
                    break
                try:
                    down.sendall(chunk)
                except OSError:
                    break
                self._fabric.count("bytes", (self.link, "s2c"), len(chunk))
        finally:
            severed.set()
            self._leave(down, up, down, left)

    # -- lifecycle --------------------------------------------------------
    def stop(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        # Join the accept loop BEFORE snapshotting the pump threads: it
        # is the only spawner, so once it exits the list is final (a
        # snapshot taken first could miss a connection accepted
        # concurrently with stop(), and leak its sockets and pump
        # threads past stop()).  The loop blocks at most ~5s in an
        # upstream connect (create_connection timeout), so 6s covers a
        # partitioned upstream; if it is somehow still alive, sweep
        # again rather than trusting a pre-join snapshot.
        self._accept_thread.join(timeout=6.0)
        for _attempt in range(2):
            with self._lock:
                threads = list(self._threads)
            # the pumps see _stop within one tick of their socket
            # timeouts, and the last out of each connection closes its
            # sockets (_leave): closing them here, while a pump may sit
            # in recv, would race it on the descriptor
            for t in threads:
                t.join(timeout=2.0)
            if not self._accept_thread.is_alive():
                break
            self._accept_thread.join(timeout=2.0)


class ChaosFabric:
    """The chaos proxies for a whole server group: one
    :class:`ChaosLink` per upstream ``host:port``, exposing a drop-in
    proxied ``hosts`` string and ONE merged deterministic event log.

    ``upstreams`` is a ``host:port,host:port`` spec (server-rank order,
    the same format ``KVWorker`` takes) or a list of ``(host, port)``
    pairs.  Windows in the plan are relative to fabric construction.
    ``protocol``: the links' client->server framing — ``"kv"`` (native
    PS links, the default) or ``"serve"`` (the serving tier's line
    protocol; see :class:`ChaosLink`).
    """

    def __init__(self, upstreams, plan: FaultPlan, *, seed: int | None = None,
                 protocol: str = "kv", killer=None):
        if seed is not None:
            plan = FaultPlan(faults=plan.faults, seed=int(seed))
        self.plan = plan
        #: kill-fault executor: callable taking the fault's ``target``
        #: string ("rank:N" / "group") and SIGKILLing it.  The proxy
        #: holds sockets, not pids, so the process owner registers this
        #: (ServerGroup for via_chaos groups; launch chaos via --pids).
        self._killer = killer
        self._kill_fired: set[int] = set()
        self._kill_lock = sync.Lock()
        if isinstance(upstreams, str):
            pairs = []
            for part in upstreams.split(","):
                host, _, port = part.rpartition(":")
                if not host or not port.isdigit():
                    raise ValueError(
                        f"bad upstream {part!r} (want host:port)")
                pairs.append((host, int(port)))
        else:
            pairs = [(h, int(p)) for h, p in upstreams]
        if not pairs:
            raise ValueError("need at least one upstream server")
        bad = [f.index for f in plan.faults
               if f.links is not None and max(f.links) >= len(pairs)]
        if bad:
            raise ValueError(
                f"fault[{bad[0]}].links names a link >= the fabric's "
                f"{len(pairs)} upstream(s)")
        badt = [f.index for f in plan.faults
                if f.kind == "kill" and f.target.startswith("rank:")
                and int(f.target[5:]) >= len(pairs)]
        if badt:
            raise ValueError(
                f"fault[{badt[0]}].target names a rank >= the fabric's "
                f"{len(pairs)} upstream(s)")
        self._events: list[tuple] = []
        self._events_lock = sync.Lock()
        #: the log hit _MAX_EVENTS and dropped events: past the cap the
        #: surviving set depends on thread arrival order, so the
        #: determinism contract no longer holds — comparisons must check
        #: this flag instead of silently diffing a truncated log
        self.events_truncated = False
        #: the fault counters, ``{name: {key: value}}`` (:data:`COUNTERS`)
        self.counters: dict[str, dict] = {name: {} for name in COUNTERS}
        #: ``(wall time, link, kind, detail)`` of each logged event
        self.timeline: list[tuple] = []
        self.started_at = sync.monotonic()
        self.links = [ChaosLink(i, up, plan, self, protocol=protocol)
                      for i, up in enumerate(pairs)]
        # time-triggered kills ride the fabric clock, one timer thread
        # per at_s fault (stopped/joined by stop())
        self._stopped = sync.Event()
        self._kill_timers: list[sync.Thread] = []
        for f in plan.faults:
            if f.kind == "kill" and f.at_s is not None:
                t = sync.Thread(target=self._kill_at, args=(f,),
                                daemon=True, name=f"chaos-kill-{f.index}")
                self._kill_timers.append(t)
                t.start()

    @property
    def hosts(self) -> str:
        """Proxied connection spec — hand this to clients in place of
        the real server group's ``hosts``.  Links are in CREATION order;
        an elastic group that adds/retires upstreams mid-run keeps its
        own rank->link mapping (ServerGroup._chaos_links) instead."""
        return ",".join(f"127.0.0.1:{lk.port}" for lk in self.links)

    def add_upstream(self, host: str, port: int) -> ChaosLink:
        """Grow the fabric by one link (the elastic-fleet hook: a server
        rank spawned mid-run gets its own fault-injecting proxy, so a
        resharded group stays fully behind the plan).  The new link gets
        the next link index: plan faults with ``links: null`` apply to
        it; faults naming explicit link indices keep meaning the links
        that existed when the plan was written."""
        lk = ChaosLink(len(self.links), (host, int(port)), self.plan, self,
                       protocol=self.links[0].protocol if self.links
                       else "kv")
        self.links.append(lk)
        return lk

    def now(self) -> float:
        return sync.monotonic() - self.started_at

    # -- kill faults (the power-loss primitive) ----------------------------
    def set_killer(self, killer) -> None:
        """Register/replace the kill-fault executor — a callable taking
        the fault's ``target`` string (``"rank:N"`` / ``"group"``).
        ServerGroup wires this AFTER constructing the fabric (the group
        owns the pids); standalone ``launch chaos`` passes one at
        construction from ``--pids``."""
        self._killer = killer

    def _kill_at(self, f: FaultSpec) -> None:
        while not self._stopped.is_set():
            remaining = f.at_s - self.now()
            if remaining <= 0:
                self.fire_kill(f, -1, at_s=f.at_s)
                return
            self._stopped.wait(min(_TICK_S, remaining))

    def fire_kill(self, f: FaultSpec, link: int, **detail) -> None:
        """Execute a kill fault ONCE fabric-wide (claim-then-act under
        the fabric lock: several connections pump the observing link
        concurrently and must not double-SIGKILL).  ``link`` is the
        observing link for after_ops kills, ``-1`` for fabric-clock
        (at_s) kills.  The canonical event records the PLAN's offset
        (op index or at_s), never wall time, and is recorded whether or
        not a killer is registered — a plan's fault timeline must not
        depend on deployment wiring."""
        with self._kill_lock:
            if f.index in self._kill_fired:
                return
            self._kill_fired.add(f.index)
        self.record(link, "kill", fault=f.index, target=f.target, **detail)
        self.count("faults", ("kill", link))
        killer = self._killer
        if killer is None:
            log.warning(
                "chaos: kill fault[%d] (target=%s) fired but no killer "
                "is registered — event recorded, nothing SIGKILLed "
                "(ServerGroup(via_chaos=...) wires one automatically; "
                "standalone `launch chaos` needs --pids)",
                f.index, f.target)
            return
        try:
            killer(f.target)
        except Exception:
            # the killer touches ANOTHER process's lifecycle; its
            # failure must not take down the pump/timer thread
            log.exception("chaos: killer failed for fault[%d] target=%s",
                          f.index, f.target)

    def count(self, name: str, key, by: float = 1) -> None:
        """Add ``by`` to counter ``name`` (one of :data:`COUNTERS`) at
        ``key``; the pumps of every link call it."""
        with self._events_lock:
            series = self.counters[name]
            series[key] = series.get(key, 0) + by
        family, labels = _SERIES[name]
        family.labels(**labels(key)).inc(by)

    def record(self, link: int, kind: str, **detail) -> None:
        # the fault as a dtrace instant on the link's track too (journaled
        # when this process's tracing is armed); the event log below stays
        # wall-clock-free and byte-comparable
        dtrace.instant(f"chaos.{kind}", tags={"link": link, **detail})
        with self._events_lock:
            if len(self._events) < _MAX_EVENTS:
                self._events.append(
                    (link, kind) + tuple(sorted(detail.items())))
                # the wall-clock twin of the event
                self.timeline.append((sync.wall(), link, kind, dict(detail)))
            elif not self.events_truncated:
                self.events_truncated = True
                log.warning(
                    "chaos event log hit its %d-event cap; further "
                    "events are DROPPED and the log is no longer "
                    "byte-comparable across runs (events_truncated=True)",
                    _MAX_EVENTS)

    def events(self) -> list[tuple]:
        """The fault-event log in CANONICAL order (sorted, not arrival
        order): wall-clock-free by construction — op/byte offsets, plan
        windows, and hash-derived delay values only — so two runs of the
        same seed + plan + client op sequence compare equal.  Valid for
        cross-run comparison only while :attr:`events_truncated` is
        False (past the cap, which events survived depends on thread
        arrival order)."""
        with self._events_lock:
            return sorted(self._events)

    def events_doc(self) -> dict:
        """The canonical event log as a schema-pinned document (what
        ``launch chaos --events-path`` writes; ``load_events_doc`` is
        the matching reader)."""
        with self._events_lock:
            events = sorted(self._events)
            truncated = self.events_truncated
        return {
            "schema": EVENT_SCHEMA,
            "seed": self.plan.seed,
            "truncated": truncated,
            "events": [list(e[:2]) + [dict(e[2:])] for e in events],
        }

    def stop(self) -> None:
        self._stopped.set()
        for t in self._kill_timers:
            t.join(timeout=2.0)
        for lk in self.links:
            lk.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
