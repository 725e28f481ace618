"""The Python mirror of the native durable-store disk formats (the port's
copy of ``distlr_tpu/ps/store.py``).

``ps/native/kv_protocol.h`` (its "durable store" section) is the single
C++ definition of the snapshot and WAL layouts ``distlr_kv_server
--store_dir`` writes; this module is their Python definition in the port.
Every Python site that reads store bytes (the supervisor's re-seed
preference in :mod:`distlr_tpu_torch.ps.server`, the ``launch ps-ctl
store`` verb, the RPO audits of the tests and the smoke) imports the names
and readers from here.  ``tests/test_torch_store.py`` holds the constants
to the header's ``kStore*`` / ``kWal*``.

Stdlib only (``struct``, ``zlib``, ``array``): the supervisor and
``ps-ctl`` are control plane and must stay cheap to import.  CRC32 is ``zlib.crc32`` — the native
writer uses the same (reflected ``0xEDB88320``) polynomial, pinned by
the round-trip tests.

Reading is strictly NON-destructive and loud: a torn or CRC-failing
snapshot generation comes back as ``valid=False`` with a named reason
(never an exception mid-scan — a disaster inspection must describe a
half-burned store, not crash on it), and WAL scans report the torn
tail instead of pretending the segment ended cleanly.
"""

from __future__ import annotations

import array
import dataclasses
import os
import struct
import zlib

from distlr_tpu_torch.ps import wire

# --- on-disk format constants (kv_protocol.h durable-store section) ----
#: snapshot file magic (kStoreMagic)
STORE_MAGIC = 0xD157510D
#: schema version, shared by snapshots and WAL segments (kStoreVersion)
STORE_VERSION = 1
#: fixed snapshot header size in bytes (kStoreHeaderSize)
STORE_HEADER_SIZE = 40
#: snapshot generations kept on disk, snap-0..snap-N-1 (kStoreGenerations)
STORE_GENERATIONS = 2
#: snapshot header flag: payload carries FTRL z/n after the weights
STORE_FLAG_FTRL = 1
#: snapshot header flag: the rank had been initialized at capture
STORE_FLAG_INITIALIZED = 2
#: WAL segment file magic (kWalMagic)
WAL_MAGIC = 0xD157106D
#: WAL segment header size in bytes (kWalHeaderSize)
WAL_HEADER_SIZE = 8
#: WAL per-record header size in bytes (kWalRecordHeaderSize)
WAL_RECORD_HEADER_SIZE = 20

# --- file structs ------------------------------------------------------
#: snapshot header: magic u32, version u16, flags u16, epoch u16,
#: reserved u16, crc u32 (CRC32 of the header with this field zeroed +
#: the whole payload), dim u64, push_clock u64, wall_time f64
SNAP_HEADER_STRUCT = struct.Struct("<IHHHHIQQd")
#: WAL segment header: magic u32, version u16, epoch u16
WAL_SEGMENT_STRUCT = struct.Struct("<IHH")
#: WAL record header: seq u64, nkeys u32, flags u8, op u8, reserved u16,
#: crc u32 (CRC32 of the record payload: keys then vals)
WAL_RECORD_STRUCT = struct.Struct("<QIBBHI")

# The struct formats must agree with the header's size constants:
# checked at import, so a format edit can never ship a misframed reader.
assert SNAP_HEADER_STRUCT.size == STORE_HEADER_SIZE
assert WAL_SEGMENT_STRUCT.size == WAL_HEADER_SIZE
assert WAL_RECORD_STRUCT.size == WAL_RECORD_HEADER_SIZE


class StoreError(Exception):
    """A store file that cannot be used (named reason in the message)."""


@dataclasses.dataclass(frozen=True)
class SnapshotMeta:
    """One snapshot generation's validated header (payload not loaded).

    ``present=False`` means the file does not exist; ``valid=False``
    with ``present=True`` means it exists but was REJECTED — ``why``
    names the defect (bad magic / version / size / CRC), exactly what
    the native loader prints before falling back a generation."""

    path: str
    present: bool = False
    valid: bool = False
    why: str = ""
    version: int = 0
    flags: int = 0
    epoch: int = 0
    dim: int = 0
    push_clock: int = 0
    wall_time: float = 0.0
    size_bytes: int = 0

    @property
    def has_ftrl(self) -> bool:
        return bool(self.flags & STORE_FLAG_FTRL)

    @property
    def initialized(self) -> bool:
        return bool(self.flags & STORE_FLAG_INITIALIZED)


def snapshot_paths(rank_dir: str) -> tuple[str, ...]:
    """The generation file paths of one rank's store directory."""
    return tuple(os.path.join(rank_dir, f"snap-{g}.bin")
                 for g in range(STORE_GENERATIONS))


def read_snapshot_meta(path: str) -> SnapshotMeta:
    """Validate one generation: header sanity + full-file CRC.  Never
    raises on bad content — rejection is data (``valid``/``why``)."""
    try:
        f = open(path, "rb")
    except OSError:
        return SnapshotMeta(path=path)
    with f:
        hdr = f.read(STORE_HEADER_SIZE)
        if len(hdr) < STORE_HEADER_SIZE:
            return SnapshotMeta(path=path, present=True, why="short header")
        (magic, version, flags, epoch, _reserved, crc, dim, clock,
         wall) = SNAP_HEADER_STRUCT.unpack(hdr)
        meta = dict(path=path, present=True, version=version, flags=flags,
                    epoch=epoch, dim=dim, push_clock=clock, wall_time=wall,
                    size_bytes=STORE_HEADER_SIZE)
        if magic != STORE_MAGIC:
            return SnapshotMeta(**meta, why="bad magic")
        if version != STORE_VERSION:
            return SnapshotMeta(**meta, why="unknown version")
        vecs = 3 if flags & STORE_FLAG_FTRL else 1
        want = dim * vecs * 4
        # stream the payload through the CRC (a slice can be large)
        got_crc = zlib.crc32(hdr[:12] + b"\x00\x00\x00\x00" + hdr[16:])
        seen = 0
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            got_crc = zlib.crc32(chunk, got_crc)
            seen += len(chunk)
            if seen > want:
                break
        meta["size_bytes"] = STORE_HEADER_SIZE + seen
        if seen != want:
            return SnapshotMeta(
                **meta, why="payload size mismatch (torn write?)")
        if got_crc != crc:
            return SnapshotMeta(**meta, why="CRC mismatch")
        return SnapshotMeta(**meta, valid=True)


def read_snapshot(path: str) -> tuple[
        SnapshotMeta, array.array, array.array | None, array.array | None]:
    """Load a validated generation's payload: ``(meta, weights, z, n)``
    with ``z``/``n`` ``None`` for non-FTRL snapshots.  Raises
    :class:`StoreError` when the file is absent or rejected — callers
    that want rejection-as-data use :func:`read_snapshot_meta`."""
    meta = read_snapshot_meta(path)
    if not meta.present:
        raise StoreError(f"{path}: no such snapshot")
    if not meta.valid:
        raise StoreError(f"{path}: rejected ({meta.why})")
    with open(path, "rb") as f:
        f.seek(STORE_HEADER_SIZE)
        weights = array.array("f")
        weights.frombytes(f.read(meta.dim * 4))
        z = n = None
        if meta.has_ftrl:
            z = array.array("f")
            z.frombytes(f.read(meta.dim * 4))
            n = array.array("f")
            n.frombytes(f.read(meta.dim * 4))
    return meta, weights, z, n


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded WAL record (flags/op are the wire bits the native
    writer stamped — see kv_protocol.h for the replay semantics)."""

    seq: int
    flags: int
    op: int
    reserved: int
    keys: tuple[int, ...]
    vals: tuple[float, ...]

    @property
    def is_epoch(self) -> bool:
        return self.op == wire.OP_EPOCH

    @property
    def epoch(self) -> int:
        return self.reserved


@dataclasses.dataclass(frozen=True)
class WalInfo:
    """One scanned segment: record count, last sequence, torn-tail flag."""

    path: str
    start_clock: int
    valid: bool = False
    why: str = ""
    records: int = 0
    last_seq: int = 0
    torn: bool = False
    size_bytes: int = 0


def wal_segments(rank_dir: str) -> tuple[tuple[int, str], ...]:
    """All ``wal-<clock>.log`` segments of a rank dir, sorted by start
    clock (the rotation clock in the name — replay order)."""
    segs = []
    try:
        names = os.listdir(rank_dir)
    except OSError:
        return ()
    for name in names:
        if not (name.startswith("wal-") and name.endswith(".log")):
            continue
        try:
            clock = int(name[4:-4])
        except ValueError:
            continue
        segs.append((clock, os.path.join(rank_dir, name)))
    return tuple(sorted(segs))


def _wal_start_clock(path: str) -> int:
    name = os.path.basename(path)
    try:
        return int(name[4:-4])
    except ValueError:
        return 0


def iter_wal(path: str):
    """Yield :class:`WalRecord` for every intact record of a segment.

    Mirrors the native replay exactly: stops at the first short or
    CRC-failing record (a torn tail is EXPECTED after a crash) — the
    stop is silent here because :func:`scan_wal` is the loud reporter.
    Raises :class:`StoreError` only for a bad segment HEADER (the whole
    file is then untrustworthy, same as the native "segment skipped")."""
    with open(path, "rb") as f:
        shdr = f.read(WAL_HEADER_SIZE)
        if len(shdr) < WAL_HEADER_SIZE:
            raise StoreError(f"{path}: short segment header")
        magic, version, _epoch = WAL_SEGMENT_STRUCT.unpack(shdr)
        if magic != WAL_MAGIC:
            raise StoreError(f"{path}: bad segment magic")
        if version != STORE_VERSION:
            raise StoreError(f"{path}: unknown segment version")
        while True:
            rhdr = f.read(WAL_RECORD_HEADER_SIZE)
            if not rhdr:
                return  # clean end
            if len(rhdr) < WAL_RECORD_HEADER_SIZE:
                return  # torn tail
            seq, nkeys, flags, op, reserved, crc = (
                WAL_RECORD_STRUCT.unpack(rhdr))
            nvals = 2 * nkeys if flags & wire.FLAG_OPT_STATE else nkeys
            payload = f.read(nkeys * 8 + nvals * 4)
            if len(payload) < nkeys * 8 + nvals * 4:
                return  # torn tail
            if zlib.crc32(payload) != crc:
                return  # corrupt record: everything after is guesswork
            keys = array.array("Q")
            keys.frombytes(payload[:nkeys * 8])
            vals = array.array("f")
            vals.frombytes(payload[nkeys * 8:])
            yield WalRecord(seq=seq, flags=flags, op=op, reserved=reserved,
                            keys=tuple(keys), vals=tuple(vals))


def scan_wal(path: str) -> WalInfo:
    """Walk one segment without retaining payloads: record count, last
    seq, and whether the tail is torn (reported, never raised)."""
    start = _wal_start_clock(path)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    info = dict(path=path, start_clock=start, size_bytes=size)
    try:
        f = open(path, "rb")
    except OSError:
        return WalInfo(**info, why="unreadable")
    with f:
        shdr = f.read(WAL_HEADER_SIZE)
        if len(shdr) < WAL_HEADER_SIZE:
            return WalInfo(**info, why="short segment header", torn=True)
        magic, version, _epoch = WAL_SEGMENT_STRUCT.unpack(shdr)
        if magic != WAL_MAGIC:
            return WalInfo(**info, why="bad segment magic")
        if version != STORE_VERSION:
            return WalInfo(**info, why="unknown segment version")
        records = 0
        last_seq = start
        torn = False
        why = ""
        while True:
            rhdr = f.read(WAL_RECORD_HEADER_SIZE)
            if not rhdr:
                break
            if len(rhdr) < WAL_RECORD_HEADER_SIZE:
                torn, why = True, "torn record header"
                break
            seq, nkeys, flags, op, _reserved, crc = (
                WAL_RECORD_STRUCT.unpack(rhdr))
            nvals = 2 * nkeys if flags & wire.FLAG_OPT_STATE else nkeys
            payload = f.read(nkeys * 8 + nvals * 4)
            if len(payload) < nkeys * 8 + nvals * 4:
                torn, why = True, "torn record payload"
                break
            if zlib.crc32(payload) != crc:
                torn, why = True, "record CRC mismatch"
                break
            records += 1
            if op != wire.OP_EPOCH:
                last_seq = max(last_seq, seq)
        return WalInfo(**info, valid=True, why=why, records=records,
                       last_seq=last_seq, torn=torn)


@dataclasses.dataclass(frozen=True)
class RankStore:
    """Everything on disk for one rank: both generations' metas, the
    scanned WAL segments, and the recovery outcome a native cold start
    would reach from them."""

    path: str
    generations: tuple[SnapshotMeta, ...]
    segments: tuple[WalInfo, ...]

    @property
    def best(self) -> SnapshotMeta | None:
        """The generation a native cold start restores: newest VALID by
        (push_clock, wall_time) — corrupt generations fall back."""
        valid = [m for m in self.generations if m.valid]
        if not valid:
            return None
        return max(valid, key=lambda m: (m.push_clock, m.wall_time))

    @property
    def corrupt(self) -> int:
        """Generations present on disk but rejected (torn/corrupt)."""
        return sum(1 for m in self.generations if m.present and not m.valid)

    @property
    def snapshot_clock(self) -> int:
        best = self.best
        return best.push_clock if best else 0

    @property
    def recovered_clock(self) -> int:
        """The push clock a native restart reaches: best snapshot plus
        every intact WAL record past it — the RPO audit's denominator."""
        clock = self.snapshot_clock
        for seg in self.segments:
            if seg.valid:
                clock = max(clock, seg.last_seq)
        return clock

    @property
    def wal_records(self) -> int:
        return sum(s.records for s in self.segments if s.valid)

    @property
    def torn(self) -> bool:
        return any(s.torn for s in self.segments)

    @property
    def snapshot_bytes(self) -> int:
        return sum(m.size_bytes for m in self.generations if m.present)

    @property
    def wal_bytes(self) -> int:
        return sum(s.size_bytes for s in self.segments)


def scan_rank(rank_dir: str) -> RankStore:
    """Scan one rank's store directory (never raises on bad content)."""
    return RankStore(
        path=rank_dir,
        generations=tuple(read_snapshot_meta(p)
                          for p in snapshot_paths(rank_dir)),
        segments=tuple(scan_wal(p) for _, p in wal_segments(rank_dir)),
    )


def rank_doc(store: RankStore, *, now: float | None = None) -> dict:
    """JSON-able inspection doc for one rank — the ``ps-ctl store``
    payload and the supervisor's ``distlr_ps_store_*`` metric source."""
    best = store.best
    doc = {
        "path": store.path,
        "generations": [
            {
                "path": m.path,
                "present": m.present,
                "valid": m.valid,
                "why": m.why,
                "epoch": m.epoch,
                "dim": m.dim,
                "push_clock": m.push_clock,
                "wall_time": m.wall_time,
                "size_bytes": m.size_bytes,
                "has_ftrl": m.has_ftrl,
                "initialized": m.initialized,
            }
            for m in store.generations
        ],
        "corrupt_generations": store.corrupt,
        "snapshot_clock": store.snapshot_clock,
        "recovered_clock": store.recovered_clock,
        "wal": {
            "segments": len(store.segments),
            "records": store.wal_records,
            "torn": store.torn,
            "bytes": store.wal_bytes,
        },
        "snapshot_bytes": store.snapshot_bytes,
    }
    if best is not None:
        doc["best"] = os.path.basename(best.path)
        doc["epoch"] = best.epoch
        doc["dim"] = best.dim
        if now is not None:
            doc["snapshot_age_s"] = max(0.0, now - best.wall_time)
    return doc


def inspect_store(root: str, *, now: float | None = None) -> dict:
    """Inspect a whole group store (``<root>/rank-<r>/``), or a single
    rank directory when ``root`` itself holds the snap/wal files —
    the ``launch ps-ctl store`` document."""
    ranks: dict[str, dict] = {}
    try:
        names = sorted(os.listdir(root))
    except OSError as e:
        raise StoreError(f"{root}: {e}") from e
    for name in names:
        if name.startswith("rank-"):
            sub = os.path.join(root, name)
            if os.path.isdir(sub):
                ranks[name[len("rank-"):]] = rank_doc(scan_rank(sub),
                                                      now=now)
    if not ranks and any(n.startswith(("snap-", "wal-")) for n in names):
        ranks["0"] = rank_doc(scan_rank(root), now=now)
    return {"root": root, "ranks": ranks}
