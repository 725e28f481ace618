"""Python KV worker: a ctypes binding of the port's native client library
(the dense and keyed surface of ``distlr_tpu/ps/client.py``'s ``KVWorker``).

API mirror of ps-lite's ``KVWorker<float>`` as used by the reference
(``Push``/``Pull``/``Wait``, call sites ``src/lr.cc:116-132``,
``src/main.cc:135-148``).  Every op calls the same native entry point the
JAX package's client calls, with the same arguments, so the frames on the
wire are that client's byte for byte.  Each call releases the GIL inside
``ctypes``: a worker blocked in a sync push (the BSP barrier is the
server's deferred reply) does not hold up the other worker threads.

Keyed ops take ``vals_per_key=R`` rows: one u64 row id on the wire per R
values (ps-lite's uniform ``lens``), the keyed PS families' encoding.

Not ported yet: the retry policy, membership epochs and re-routing, wire
codecs (ROADMAP A.16), namespaces (A.17) and the trace spans and registry
counters (A.12).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from distlr_tpu_torch.ps import wire
from distlr_tpu_torch.ps.build import client_lib

#: Order of the counters a server stats probe returns (kv_protocol.h);
#: the ``cpu_*`` tail is per-handler thread-CPU seconds.
STATS_FIELDS = (
    "dim",
    "initialized",
    "pending_sync_pushes",
    "barrier_waiters",
    "total_pushes",
    "total_pulls",
    "cpu_push_seconds",
    "cpu_pull_seconds",
    "cpu_stats_seconds",
    "cpu_barrier_seconds",
    "epoch",
)
if len(STATS_FIELDS) != wire.STATS_VALS or STATS_FIELDS[wire.STATS_VALS_V1 - 1] != "total_pulls":
    raise ImportError("STATS_FIELDS disagrees with kv_protocol.h's kStats layout (ps/wire.py)")

_lock = threading.Lock()
_lib = None


class PSTimeoutError(TimeoutError):
    """A KV op hit the receive timeout: in sync mode, a dead or slow
    worker holding the BSP barrier (the reference deadlocks forever
    there, SURVEY.md §5.3)."""


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(client_lib()))
                lib.kv_connect.restype = ctypes.c_void_p
                lib.kv_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
                for name in ("kv_push_vpk", "kv_pull_vpk"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_uint64]
                lib.kv_push_pull_vpk.restype = ctypes.c_int
                lib.kv_push_pull_vpk.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ]
                lib.kv_push_init.restype = ctypes.c_int
                lib.kv_push_init.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ]
                lib.kv_barrier.restype = ctypes.c_int
                lib.kv_barrier.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
                lib.kv_wait.restype = ctypes.c_int
                lib.kv_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_shutdown_servers.restype = ctypes.c_int
                lib.kv_shutdown_servers.argtypes = [ctypes.c_void_p]
                lib.kv_set_timeout_ms.restype = ctypes.c_int
                lib.kv_set_timeout_ms.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_set_push_visit_all.restype = ctypes.c_int
                lib.kv_set_push_visit_all.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_timed_out.restype = ctypes.c_int
                lib.kv_timed_out.argtypes = [ctypes.c_void_p]
                lib.kv_stats.restype = ctypes.c_int
                lib.kv_stats.argtypes = [  # out buffer is float64 (see kv_protocol.h)
                    ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64,
                ]
                lib.kv_last_error.restype = ctypes.c_char_p
                lib.kv_last_error.argtypes = [ctypes.c_void_p]
                lib.kv_close.restype = None
                lib.kv_close.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class KVWorker:
    """Blocking Push/Pull/Wait client over a range-sharded server group.

    ``hosts`` is ``"ip:port,..."`` in server-rank order; server ``r`` of
    ``S`` owns keys ``[r*dim/S, (r+1)*dim/S)``.  ``timeout_ms`` bounds
    every receive (0 blocks forever, the reference's semantics).
    ``sync_group=False`` (an async group) lets keyed pushes skip servers
    whose key slice is empty; a sync group must visit all, because an
    empty push is that worker's vote in the BSP round.  Ops on one
    worker must not overlap: one connection per server, one op at a time.
    """

    def __init__(self, hosts: str, dim: int, client_id: int = 0, *,
                 timeout_ms: int = 0, sync_group: bool = True):
        self._lib = _load()
        self.hosts = hosts
        self.dim = int(dim)
        self.num_servers = hosts.count(",") + 1
        self._client_id = client_id
        self._timeout_ms = int(timeout_ms)
        self._sync_group = sync_group
        self._h = self._build_handle()
        # dense default key set 0..D-1, like the reference app (src/lr.cc:117-121)
        self._all_keys = np.arange(self.dim, dtype=np.uint64)

    def _build_handle(self):
        """A new native handle with this worker's hosts, dim, client id,
        timeout and group mode."""
        lib = self._lib
        h = lib.kv_connect(self.hosts.encode(), self.dim, self._client_id)
        if not h:
            raise ConnectionError(f"could not connect to KV servers at {self.hosts}")
        if self._timeout_ms and lib.kv_set_timeout_ms(h, self._timeout_ms) != 0:
            lib.kv_close(h)
            raise OSError("failed to set KV socket timeout")
        if not self._sync_group:
            lib.kv_set_push_visit_all(h, 0)
        return h

    def reconnect(self) -> None:
        """Rebuild the native handle in place, the way out of a poisoned
        connection (after one failed receive every later op on that stream
        fails).  The new connections open before the old ones close, so a
        failed reconnect (servers still down) raises and leaves the old
        handle as it was."""
        h = self._build_handle()
        old, self._h = self._h, h
        if old:
            self._lib.kv_close(old)

    def set_timeout(self, timeout_ms: int) -> None:
        """Receive timeout for every op; 0 = block forever."""
        if self._lib.kv_set_timeout_ms(self._h, int(timeout_ms)) != 0:
            raise OSError("failed to set KV socket timeout")
        self._timeout_ms = int(timeout_ms)

    def _check(self, ts: int, what: str) -> int:
        if ts < 0:
            err = self._lib.kv_last_error(self._h).decode()
            if self._lib.kv_timed_out(self._h):
                raise PSTimeoutError(f"KV {what} timed out: {err}")
            raise OSError(f"KV {what} failed: {err}")
        return ts

    def _validate_keys(self, keys, vpk: int = 1) -> np.ndarray:
        """``keys`` as strictly ascending in-range u64s (the native range
        slicer binary-searches range boundaries).  With ``vpk > 1`` keys
        are row ids over a ``dim // vpk`` row space."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        space = self.dim // vpk
        if keys.size:
            kmax = int(keys.max())
            if kmax >= space:
                raise ValueError(f"key {kmax} out of range (dim={self.dim}"
                                 + (f", vals_per_key={vpk} -> {space} rows)" if vpk > 1
                                    else ")"))
            if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
                raise ValueError("keys must be strictly ascending")
        return keys

    def supports_vals_per_key(self, vpk: int) -> bool:
        """Whether ``vals_per_key=vpk`` ops can be range-sliced over this
        group: every range boundary (``dim*s/S``) must be a multiple of
        vpk, so no row straddles two servers.  Where it is False, callers
        send expanded per-lane keys instead."""
        if vpk <= 1:
            return True
        if self.dim % vpk != 0:
            return False
        return all((self.dim * s // self.num_servers) % vpk == 0
                   for s in range(1, self.num_servers))

    def _default_or_validated(self, keys, vpk: int) -> np.ndarray:
        """The dense default key set (flat ids, so never with ``vpk > 1``:
        that would reinterpret flat ids as row ids), or ``keys`` checked."""
        if keys is None:
            if vpk != 1:
                raise ValueError("vals_per_key > 1 requires explicit row keys (the dense "
                                 "default key set is flat ids, not rows)")
            return self._all_keys
        return self._validate_keys(keys, vpk)

    def _frame(self, vals, keys, vpk: int) -> tuple[np.ndarray, np.ndarray]:
        """A push's ``(keys, vals)``: ``vals`` holds ``len(keys) * vpk``
        f32s, row-major."""
        vals = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
        keys = self._default_or_validated(keys, vpk)
        if vals.shape[0] != keys.shape[0] * vpk:
            raise ValueError(f"{vals.shape[0]} vals vs {keys.shape[0]} keys "
                             f"x vals_per_key {vpk}")
        return keys, vals

    def push(self, vals: np.ndarray, keys: np.ndarray | None = None, *,
             vals_per_key: int = 1) -> int:
        """Blocking push; in sync mode it returns only after ALL workers
        pushed (the server's deferred reply is the BSP barrier).  The
        first push to an uninitialized group seeds the weights.

        ``vals_per_key=R``: keys are R-lane ROW ids (row ``k`` owns flat
        slots ``[k*R, (k+1)*R)``) and ``vals`` holds ``len(keys)*R`` floats
        row-major, one u64 of key on the wire per R values (requires
        :meth:`supports_vals_per_key`)."""
        vpk = int(vals_per_key)
        keys, vals = self._frame(vals, keys, vpk)
        ts = self._lib.kv_push_vpk(self._h, _ptr(keys), _ptr(vals), keys.shape[0], vpk)
        return self._check(ts, "push")

    def push_init(self, vals: np.ndarray, keys: np.ndarray | None = None,
                  *, force: bool = False) -> int:
        """Idempotent weight-seeding push: initializes an uninitialized
        group and no-ops otherwise (kInitPush); ``force=True`` overwrites
        live weights (kForceInit)."""
        keys, vals = self._frame(vals, keys, 1)
        ts = self._lib.kv_push_init(self._h, _ptr(keys), _ptr(vals), keys.shape[0],
                                    1 if force else 0)
        return self._check(ts, "push_init")

    def push_pull(self, vals: np.ndarray, keys: np.ndarray | None = None, *,
                  vals_per_key: int = 1) -> np.ndarray:
        """Fused push + pull: push a gradient and receive the post-update
        weights for the same keys in ONE round trip per server (the
        reference spends two per batch, ``src/lr.cc:116-132``).  Sync:
        blocks through the BSP round; the reply is the post-round state,
        the same bits as the pull that would have followed.
        ``vals_per_key``: see :meth:`push`."""
        vpk = int(vals_per_key)
        keys, vals = self._frame(vals, keys, vpk)
        out = np.empty(keys.shape[0] * vpk, dtype=np.float32)
        ts = self._lib.kv_push_pull_vpk(self._h, _ptr(keys), _ptr(vals), _ptr(out),
                                        keys.shape[0], vpk)
        self._check(ts, "push_pull")
        return out

    def pull(self, keys: np.ndarray | None = None, *, vals_per_key: int = 1) -> np.ndarray:
        """Blocking pull of ``keys`` (default: all ``dim`` weights).
        ``vals_per_key=R``: keys are row ids and the result holds
        ``len(keys)*R`` floats row-major (see :meth:`push`)."""
        vpk = int(vals_per_key)
        keys = self._default_or_validated(keys, vpk)
        out = np.empty(keys.shape[0] * vpk, dtype=np.float32)
        ts = self._lib.kv_pull_vpk(self._h, _ptr(keys), _ptr(out), keys.shape[0], vpk)
        self._check(ts, "pull")
        return out

    def pull_chunked(self, keys: np.ndarray | None = None, *, vals_per_key: int = 1,
                     chunk_rows: int = 1 << 16) -> np.ndarray:
        """Pull a large key set as a sequence of keyed pulls of at most
        ``chunk_rows`` rows each, so a periodic weight refresh never holds a
        server's receive loop for a whole table against a trainer pushing
        to the same group (the scoring tier's read path).  ``keys=None``
        pulls the full row space ``0..dim/vals_per_key`` as explicit keys;
        an ascending ``keys`` array (hot-row serving) is chunked as given;
        an empty one gives an empty f32 array."""
        vpk = int(vals_per_key)
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        if vpk > 1 and not self.supports_vals_per_key(vpk):
            raise ValueError(f"vals_per_key={vpk} rows straddle this group's range "
                             "boundaries; pull with vals_per_key=1 instead")
        if keys is None:
            space = self.dim // vpk
            parts = [self.pull(np.arange(lo, min(lo + chunk_rows, space), dtype=np.uint64),
                               vals_per_key=vpk)
                     for lo in range(0, space, chunk_rows)]
        else:
            keys = self._validate_keys(keys, vpk)
            parts = [self.pull(keys[lo:lo + chunk_rows], vals_per_key=vpk)
                     for lo in range(0, keys.shape[0], chunk_rows)]
        if not parts:
            return np.empty(0, np.float32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def pull_rows_into(self, table: np.ndarray, keys: np.ndarray, *, vals_per_key: int = 1,
                       chunk_rows: int = 1 << 16) -> int:
        """Keyed hot-slice pull: fetch only the ``keys`` rows and scatter
        them into ``table`` in place (the serving tier's working-set
        refresh, :mod:`distlr_tpu_torch.serve.hotset`).  A refresh moves
        ``rows * (8 + 4*vpk)`` wire bytes; every cold row of ``table``
        keeps the last full pull's value.  ``table`` must be a
        C-contiguous float32 array of ``dim`` elements (flat or
        ``(rows, vals_per_key)``); returns the rows pulled."""
        vpk = int(vals_per_key)
        table = np.asarray(table)
        if table.dtype != np.float32 or table.size != self.dim or not table.flags["C_CONTIGUOUS"]:
            raise ValueError(f"table must be C-contiguous float32 with {self.dim} elements, "
                             f"got {table.dtype} shape {table.shape}")
        keys = self._validate_keys(keys, vpk)
        if keys.size == 0:
            return 0
        vals = self.pull_chunked(keys, vals_per_key=vpk, chunk_rows=chunk_rows)
        table.reshape(self.dim // vpk, vpk)[keys.astype(np.int64)] = vals.reshape(-1, vpk)
        return int(keys.size)

    def wait(self, ts: int) -> None:
        """No-op for API parity: push and pull already block (the
        reference pairs every Push/Pull with an immediate Wait)."""
        self._lib.kv_wait(self._h, ts)

    def barrier(self, barrier_id: int = 0) -> None:
        """Worker-group barrier via server 0 (``Postoffice::Barrier``,
        reference ``src/main.cc:150``).  ``barrier_id`` is the
        generation: a late vote for a released generation returns at
        once."""
        if not 0 <= barrier_id <= wire.AUX_MAX:
            # the wire field is u16 (MsgHeader::aux): truncation could
            # alias a released generation
            raise ValueError(f"barrier_id must fit in uint16, got {barrier_id}")
        self._check(self._lib.kv_barrier(self._h, barrier_id), "barrier")

    def stats(self, server: int = 0) -> dict:
        """Counters of one server (never deferred, so it answers while
        the sync barrier waits)."""
        out = np.zeros(len(STATS_FIELDS), dtype=np.float64)
        n = self._check(self._lib.kv_stats(self._h, server, _ptr(out), out.shape[0]), "stats")
        return {name: float(v) if name.startswith("cpu_") else int(v)
                for name, v in zip(STATS_FIELDS, out[:n])}

    def global_pushes(self) -> float:
        """The group's push clock: every server's ``total_pushes`` summed
        and divided by the server count, so one dense push (which lands
        on every range) ticks it by 1.  The seeding push counts too."""
        return sum(self.stats(r)["total_pushes"] for r in range(self.num_servers)) / self.num_servers

    def shutdown_servers(self) -> None:
        self._lib.kv_shutdown_servers(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
