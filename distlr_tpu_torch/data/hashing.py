"""Feature hashing for the CTR data paths (copy of the numpy parts of
``distlr_tpu/data/hashing.py``).

Categorical fields of unbounded vocabulary are folded into a fixed bucket
space with a vectorized splitmix64 mixer (numpy only, deterministic,
seeded), either per field into scalar buckets — the padded-COO
``(cols, vals)`` leaves of ``sparse_lr`` / ``sparse_softmax`` — or per
group of fields into R-wide table rows — the ``(blocks, lane_vals)``
leaves of ``blocked_lr`` (:func:`hash_group_blocks`).  The synthetic CTR
generator and both shard writers produce the same bytes as the JAX
package's, so either package trains on the other's data directories.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

from distlr_tpu_torch.data.libsvm import parse_libsvm_file, parse_libsvm_lines
from distlr_tpu_torch.data.sharding import part_name

__all__ = [
    "splitmix64",
    "hash_buckets",
    "hash_group_blocks",
    "default_field_groups",
    "split_field_groups",
    "encode_blocked",
    "suggest_block_size",
    "suggest_blocking",
    "resolve_auto_block_size",
    "csr_to_padded_coo",
    "make_ctr_dataset",
    "make_uniform_blocked_batch",
    "write_ctr_shards",
    "write_raw_ctr_shards",
    "read_raw_ctr_file",
    "read_ctr_meta",
    "resolve_ctr_fields",
]

_U64 = np.uint64
_CTR_META = "ctr_meta.json"


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 array -> uint64 array."""
    x = x.astype(_U64, copy=True)
    with np.errstate(over="ignore"):
        x += _U64(0x9E3779B97F4A7C15)
        z = x
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def hash_buckets(ids: np.ndarray, num_buckets: int, *, seed: int = 0, field_ids=None):
    """Hash integer feature ids into ``[0, num_buckets)``; ``field_ids``
    namespaces ids per categorical field.  Returns ``(buckets, signs)``,
    ``signs`` the +/-1 sign hash (float32) from bit 63 of the same mix."""
    h = np.asarray(ids, dtype=np.int64).astype(_U64)
    if field_ids is not None:
        with np.errstate(over="ignore"):
            h = h + splitmix64(np.asarray(field_ids, dtype=np.int64).astype(_U64) + _U64(0x51))
    with np.errstate(over="ignore"):
        h = splitmix64(h + splitmix64(np.full_like(h, _U64(seed))))
    buckets = (h % _U64(num_buckets)).astype(np.int64)
    signs = np.where((h >> _U64(63)).astype(bool), np.float32(1.0), np.float32(-1.0))
    return buckets, signs


def hash_group_blocks(raw_ids, field_groups, num_blocks: int, *, seed: int = 0,
                      raw_vals=None):
    """Row-aligned hashing: each group of R fields hashes its value tuple
    to one table row, and lane j of that row holds member field j's weight
    under the conjunction, so one R-wide row gather replaces R scalar ones.

    ``raw_ids`` is (N, F); ``field_groups`` a (G, R) array of field
    indices, -1 padding a short group (its lane has value 0); ``raw_vals``
    optional (N, F) values (default one-hot 1.0).  Returns ``(blocks,
    lane_vals)``: (N, G) int64 row ids and (N, G, R) float32 lane values.
    """
    raw_ids = np.asarray(raw_ids, dtype=np.int64)
    groups = np.asarray(field_groups, dtype=np.int64)
    if groups.ndim != 2:
        raise ValueError("field_groups must be a (G, R) array of field indices")
    n, _ = raw_ids.shape
    g_count, r = groups.shape
    pad = groups < 0
    safe = np.where(pad, 0, groups)
    vals_f = (np.ones_like(raw_ids, dtype=np.float32) if raw_vals is None
              else np.asarray(raw_vals, dtype=np.float32))
    member_ids = raw_ids[:, safe.reshape(-1)].reshape(n, g_count, r)
    lane_vals = vals_f[:, safe.reshape(-1)].reshape(n, g_count, r).copy()
    lane_vals[:, pad] = 0.0

    # fold member (field, value) mixes in lane order, so the tuple (not the
    # multiset) is keyed; padded lanes fold a constant
    key = np.full((n, g_count), _U64(seed), dtype=_U64)
    with np.errstate(over="ignore"):
        key = splitmix64(key)
        for j in range(r):
            fj = np.where(pad[:, j], _U64(0xD1F), safe[:, j].astype(_U64))
            vj = np.where(pad[None, :, j], _U64(0), member_ids[:, :, j].astype(_U64))
            key = splitmix64(key ^ splitmix64(vj + splitmix64(fj + _U64(0x9E))))
    blocks = (key % _U64(num_blocks)).astype(np.int64)
    return blocks, lane_vals


def default_field_groups(num_fields: int, block_size: int) -> np.ndarray:
    """Fields 0..F-1 chunked into ceil(F/R) consecutive groups of R, the
    last padded with -1."""
    g_count = -(-num_fields // block_size)
    groups = np.full((g_count, block_size), -1, dtype=np.int64)
    groups.reshape(-1)[:num_fields] = np.arange(num_fields)
    return groups


def split_field_groups(num_fields: int, block_size: int,
                       num_groups: int = 0) -> np.ndarray:
    """Field grouping with an explicit group count: 0 or ceil(F/R) give
    :func:`default_field_groups` (one canonical grouping per (F, R, G), so
    a model trained one way evaluates the same the other); a larger G
    splits the fields into G near-equal consecutive groups padded to R."""
    g_min = -(-num_fields // block_size)
    if num_groups in (0, None) or num_groups == g_min:
        return default_field_groups(num_fields, block_size)
    g = int(num_groups)
    if g < g_min or g > num_fields:
        raise ValueError(
            f"num_groups={g} outside [{g_min}, {num_fields}] for "
            f"{num_fields} fields at block_size={block_size} (each group "
            f"holds at most {block_size} fields, at least 1)")
    groups = np.full((g, block_size), -1, dtype=np.int64)
    bounds = np.linspace(0, num_fields, g + 1).astype(int)
    for i in range(g):
        m = bounds[i + 1] - bounds[i]
        groups[i, :m] = np.arange(bounds[i], bounds[i + 1])
    return groups


def _distinct_group_tuples(raw_ids, groups) -> list[int]:
    """Distinct value-tuple count per group."""
    return [len(np.unique(raw_ids[:, g[g >= 0]], axis=0)) for g in groups]


def _grouping_passes(n: int, distinct: list[int], num_buckets: int, r: int,
                     min_recurrence: float, max_row_load: float,
                     max_row_load_single: float) -> bool:
    """The advisor's two gates on one grouping: every group's tuples recur
    at least ``min_recurrence`` times, and the rows they fill stay under
    the load bound (stricter for a single group, where one colliding row
    is the whole logit)."""
    recurrence = n / max(distinct)
    load = sum(distinct) / max(num_buckets // r, 1)
    load_ok = (load <= max_row_load_single if len(distinct) == 1
               else load / len(distinct) <= max_row_load)
    return recurrence >= min_recurrence and load_ok


def suggest_block_size(raw_ids, num_buckets: int,
                       candidates: tuple[int, ...] = (32, 16, 8), *,
                       min_recurrence: float = 32.0, max_row_load: float = 0.5,
                       max_row_load_single: float = 0.1) -> int:
    """The largest candidate R whose default grouping passes the
    recurrence and row-load gates on this sample of raw rows, else 1
    (scalar hashing)."""
    raw_ids = np.asarray(raw_ids, dtype=np.int64)
    n, num_fields = raw_ids.shape
    if n == 0:
        raise ValueError("suggest_block_size needs a non-empty sample of raw rows")
    for r in sorted(candidates, reverse=True):
        groups = default_field_groups(num_fields, r)
        if _grouping_passes(n, _distinct_group_tuples(raw_ids, groups), num_buckets, r,
                            min_recurrence, max_row_load, max_row_load_single):
            return r
    return 1


def suggest_blocking(raw_ids, num_buckets: int,
                     r_candidates: tuple[int, ...] = (32, 16, 8), *,
                     num_groups: int = 0, max_groups: int = 4,
                     min_recurrence: float = 32.0, max_row_load: float = 0.5,
                     max_row_load_single: float = 0.1) -> tuple[int, int]:
    """Joint (block_size, block_groups) advisor: the cheapest layout —
    fewest groups (row gathers) first, then smallest R — whose grouping
    passes the gates, else ``(1, 0)``.  ``num_groups > 0`` pins the group
    count and searches R only; the returned group count is 0 when it
    equals the default ceil(F/R) chunking."""
    raw_ids = np.asarray(raw_ids, dtype=np.int64)
    n, num_fields = raw_ids.shape
    if n == 0:
        raise ValueError("suggest_blocking needs a non-empty sample of raw rows")
    rs = sorted(r_candidates)
    if num_groups:
        g_values = [int(num_groups)]
    else:
        # the default chunking of every candidate R is always searched,
        # whatever max_groups says
        g_values = sorted(set(range(1, min(max_groups, num_fields) + 1))
                          | {-(-num_fields // r) for r in rs})
    # distinct counts depend only on group membership; the key holds the
    # shape, since a (2, 8) and a (1, 16) grouping serialize alike
    memo: dict[tuple, list[int]] = {}

    def distinct_of(groups) -> list[int]:
        key = (groups.shape, groups.tobytes())
        if key not in memo:
            memo[key] = _distinct_group_tuples(raw_ids, groups)
        return memo[key]

    any_feasible = False
    for g in g_values:
        for r in rs:
            if r * g < num_fields or g > num_fields:
                continue  # G groups of <= R lanes cannot hold every field
            any_feasible = True
            groups = split_field_groups(num_fields, r, g)
            if _grouping_passes(n, distinct_of(groups), num_buckets, r,
                                min_recurrence, max_row_load, max_row_load_single):
                return r, (0 if g == -(-num_fields // r) else g)
    if num_groups and not any_feasible:
        raise ValueError(
            f"block_groups={int(num_groups)} is infeasible for "
            f"{num_fields} fields with block-size candidates {tuple(rs)} "
            f"(need ceil(fields/G) <= R and G <= fields)")
    return 1, 0


def resolve_auto_block_size(data_dir: str, ctr_fields: int, num_buckets: int, *,
                            sample_rows: int = 100_000,
                            num_groups: int = 0) -> tuple[int, int]:
    """Resolve ``block_size=0`` ("auto") for a raw-CTR data dir: run
    :func:`suggest_blocking` on a strided sample of the first train shard
    (strided, because time-ordered logs cluster identical tuples at the
    head) over the Rs that divide ``num_buckets``."""
    path = os.path.join(data_dir, "train", part_name(0))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"block_size=0 (auto) needs raw-CTR shards to sample; no "
            f"{path} — pass an explicit --block-size instead")
    num_fields = resolve_ctr_fields(data_dir, ctr_fields)
    with open(path, "rb") as f:
        probe = list(itertools.islice(f, 200))
    if not probe:
        raise ValueError(f"{path} is empty; cannot sample for block_size auto")
    avg_line = sum(len(ln) for ln in probe) / len(probe)
    approx_rows = max(1, int(os.path.getsize(path) / avg_line))
    # ceil: a floor stride of 1 on a shard just over sample_rows keeps the head
    stride = max(1, -(-approx_rows // sample_rows))
    raw_ids, _ = read_raw_ctr_file(path, num_fields, max_rows=sample_rows, stride=stride)
    candidates = tuple(r for r in (32, 16, 8) if num_buckets % r == 0)
    return suggest_blocking(raw_ids, num_buckets, candidates, num_groups=num_groups)


def encode_blocked(raw_ids, num_blocks: int, block_size: int, *, seed: int = 0,
                   raw_vals=None, field_groups=None, num_groups: int = 0):
    """Raw ``(N, F)`` categorical ids -> ``BlockedSparseLR`` leaves
    ``(blocks (N, G) int32, lane_vals (N, G, R) float32)``; train and test
    hash alike when they share ``seed``, shape and grouping."""
    raw_ids = np.asarray(raw_ids, dtype=np.int64)
    if field_groups is None:
        field_groups = split_field_groups(raw_ids.shape[1], block_size, num_groups)
    blocks, lane_vals = hash_group_blocks(raw_ids, field_groups, num_blocks, seed=seed,
                                          raw_vals=raw_vals)
    return blocks.astype(np.int32), lane_vals


def csr_to_padded_coo(row_ptr, cols, vals, *, nnz_max: int | None = None):
    """CSR -> padded COO ``(cols int32, vals float32)`` of shape
    ``(N, nnz_max)`` (pad col 0, pad val 0); longer rows keep their first
    ``nnz_max`` entries, ``None`` takes the longest row."""
    row_ptr = np.asarray(row_ptr)
    n = len(row_ptr) - 1
    lengths = np.diff(row_ptr)
    if nnz_max is None:
        nnz_max = int(lengths.max()) if n else 0
    nnz_max = max(int(nnz_max), 1)
    out_cols = np.zeros((n, nnz_max), np.int32)
    out_vals = np.zeros((n, nnz_max), np.float32)
    j = np.arange(nnz_max)[None, :]
    valid = j < np.minimum(lengths, nnz_max)[:, None]
    src = row_ptr[:-1, None] + j
    out_cols[valid] = cols[src[valid]]
    out_vals[valid] = vals[src[valid]]
    return out_cols, out_vals


def make_ctr_dataset(num_samples: int, num_fields: int, vocab_size: int, num_buckets: int,
                     *, seed: int = 0, signed: bool = False, noise: float = 0.0,
                     num_distinct_tuples: int | None = None, center_logits: bool = False):
    """Deterministic synthetic CTR data: ``num_fields`` categorical fields
    of ``vocab_size`` values each, labels from a logistic model over the
    hashed one-hot encoding, with the ground truth ``w_true`` in bucket
    space.  ``num_distinct_tuples`` draws rows from a fixed table of that
    many tuples (correlated fields, the regime the blocked path learns
    in); ``center_logits`` keeps the base rate near 0.5.

    Returns ``(raw_ids (N, F), cols (N, F) int32, vals (N, F), y (N,)
    int32 in {0, 1}, w_true (num_buckets,))``.
    """
    rng = np.random.default_rng(seed)
    if num_distinct_tuples is not None:
        table = rng.integers(0, vocab_size, size=(num_distinct_tuples, num_fields))
        raw_ids = table[rng.integers(0, num_distinct_tuples, size=num_samples)]
    else:
        raw_ids = rng.integers(0, vocab_size, size=(num_samples, num_fields))
    field_ids = np.broadcast_to(np.arange(num_fields), raw_ids.shape)
    cols, signs = hash_buckets(raw_ids, num_buckets, seed=seed, field_ids=field_ids)
    vals = np.ones(cols.shape, np.float32)
    if signed:
        vals = vals * signs
    w_true = (rng.standard_normal(num_buckets) * (3.0 / np.sqrt(num_fields))).astype(np.float32)
    logits = np.sum(w_true[cols] * vals, axis=-1)
    if center_logits:
        logits = logits - logits.mean()
    if noise > 0.0:
        logits += noise * rng.standard_normal(num_samples)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(num_samples) < p).astype(np.int32)
    return raw_ids, cols.astype(np.int32), vals, y, w_true


def make_uniform_blocked_batch(rng, n: int, num_fields: int, num_blocks: int,
                               block_size: int):
    """Uniform-random one-hot blocked leaves ``(blocks, lane_vals)``:
    ceil(F/R) groups, the last group's padded lanes zero (the layout of
    :func:`default_field_groups`, without the hashing)."""
    g_count = -(-num_fields // block_size)
    blocks = rng.integers(0, num_blocks, size=(n, g_count)).astype(np.int32)
    lane_vals = np.ones((n, g_count, block_size), np.float32)
    pad = g_count * block_size - num_fields
    if pad:
        lane_vals[:, -1, block_size - pad:] = 0.0
    return blocks, lane_vals


def _make_split_dirs(data_dir: str) -> None:
    for sub in ("train", "test", "models"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)


def _write_parts(data_dir: str, num_parts: int, n_test: int, write, *leaves) -> tuple[list, str]:
    """Rows ``[n_test:]`` split into ``train/part-001..`` and rows
    ``[:n_test]`` into ``test/part-001``, each written by ``write(path,
    *leaf_rows)``."""
    n_train = len(leaves[0]) - n_test
    parts = []
    for i in range(num_parts):
        sl = slice(n_test + i * n_train // num_parts, n_test + (i + 1) * n_train // num_parts)
        path = os.path.join(data_dir, "train", part_name(i))
        write(path, *(a[sl] for a in leaves))
        parts.append(path)
    test_path = os.path.join(data_dir, "test", part_name(0))
    write(test_path, *(a[:n_test] for a in leaves))
    return parts, test_path


def write_ctr_shards(data_dir: str, num_samples: int, num_fields: int, vocab_size: int,
                     num_buckets: int, num_parts: int, *, seed: int = 0,
                     test_fraction: float = 0.2) -> dict:
    """Hashed one-hot CTR data as reference-layout libsvm shards, rows
    ``±1 idx:v ...`` over 1-based bucket ids (``NUM_FEATURE_DIM =
    num_buckets``), intra-row collisions summed."""
    _, cols, vals, y, w_true = make_ctr_dataset(num_samples, num_fields, vocab_size,
                                                num_buckets, seed=seed)
    _make_split_dirs(data_dir)

    def write(path, c, v, labels):
        with open(path, "w") as f:
            for i in range(len(labels)):
                toks = [str(2 * int(labels[i]) - 1)]
                # libsvm indices are unique and ascending: sum collisions
                uniq, inv = np.unique(c[i], return_inverse=True)
                summed = np.zeros(len(uniq), np.float32)
                np.add.at(summed, inv, v[i])
                toks += [f"{int(uc) + 1}:{sv:g}" for uc, sv in zip(uniq, summed) if sv != 0]
                f.write(" ".join(toks) + "\n")

    parts, test_path = _write_parts(data_dir, num_parts, int(num_samples * test_fraction),
                                    write, cols, vals, y)
    w_path = os.path.join(data_dir, "w_true.npy")
    np.save(w_path, w_true)
    return {"train_parts": parts, "test_path": test_path, "w_true_path": w_path}


def read_ctr_meta(data_dir: str) -> dict | None:
    """The raw-CTR manifest of :func:`write_raw_ctr_shards` (None for a dir
    of plain libsvm or hashed shards)."""
    path = os.path.join(data_dir, _CTR_META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def resolve_ctr_fields(data_dir: str, ctr_fields: int) -> int:
    """The raw field count: ``ctr_fields`` or the data dir's manifest; a
    conflict between the two raises here, not as a per-row parse error."""
    meta = read_ctr_meta(data_dir)
    if ctr_fields:
        if meta is not None and int(meta["num_fields"]) != int(ctr_fields):
            raise ValueError(
                f"cfg.ctr_fields={int(ctr_fields)} conflicts with "
                f"{os.path.join(data_dir, _CTR_META)} num_fields="
                f"{int(meta['num_fields'])} — drop ctr_fields to trust the "
                "manifest, or regenerate the shards")
        return int(ctr_fields)
    if meta is None:
        raise FileNotFoundError(
            f"{data_dir} has no {_CTR_META} manifest and cfg.ctr_fields is 0 "
            "— blocked_lr needs the raw field count (write shards with "
            "write_raw_ctr_shards / `launch gen-data --ctr-fields F "
            "--ctr-raw`, or set ctr_fields)")
    return int(meta["num_fields"])


def write_raw_ctr_shards(data_dir: str, num_samples: int, num_fields: int, vocab_size: int,
                         num_parts: int, *, seed: int = 0, test_fraction: float = 0.2,
                         num_distinct_tuples: int | None = None) -> dict:
    """Raw categorical CTR shards, rows ``±1 field:id ...`` (1-based field
    numbers, the raw id in the value slot), plus a ``ctr_meta.json``
    manifest: the hashing is a load-time choice.  Ids ride a float32
    slot, exact below 2**24, which is enforced here."""
    if vocab_size >= 1 << 24:
        raise ValueError(
            f"vocab_size {vocab_size} exceeds float32's exact-integer range "
            "(2^24); raw ids would corrupt in the libsvm value slot")
    raw_ids, _, _, y, w_true = make_ctr_dataset(
        num_samples, num_fields, vocab_size, max(num_fields * 64, 1024),
        seed=seed, num_distinct_tuples=num_distinct_tuples)
    _make_split_dirs(data_dir)

    def write(path, ids, labels):
        with open(path, "w") as f:
            for i in range(len(labels)):
                toks = [str(2 * int(labels[i]) - 1)]
                toks += [f"{j + 1}:{int(ids[i, j])}" for j in range(num_fields)]
                f.write(" ".join(toks) + "\n")

    parts, test_path = _write_parts(data_dir, num_parts, int(num_samples * test_fraction),
                                    write, raw_ids, y)
    meta = {"format": "raw_ctr", "num_fields": num_fields, "vocab_size": vocab_size,
            "seed": seed, "num_distinct_tuples": num_distinct_tuples}
    with open(os.path.join(data_dir, _CTR_META), "w") as f:
        json.dump(meta, f)
    w_path = os.path.join(data_dir, "w_true.npy")
    np.save(w_path, w_true)
    return {"train_parts": parts, "test_path": test_path, "w_true_path": w_path, "meta": meta}


def csr_to_raw_ids(row_ptr, cols, vals, num_fields: int, *, origin: str = "input") -> np.ndarray:
    """Validated CSR -> raw ``(N, F) int64`` ids: every row carries each of
    the F fields exactly once, with a non-negative integer id below 2^24."""
    row_ptr, cols, vals = np.asarray(row_ptr), np.asarray(cols), np.asarray(vals)
    n = len(row_ptr) - 1
    lengths = np.diff(row_ptr)
    if n and not (lengths == num_fields).all():
        bad = int(np.argmax(lengths != num_fields))
        raise ValueError(
            f"{origin}: row {bad} has {int(lengths[bad])} fields, expected "
            f"{num_fields} (raw-CTR rows carry every field)")
    if n and ((cols < 0).any() or (cols >= num_fields).any()):
        bad = int(cols[(cols < 0) | (cols >= num_fields)][0]) + 1
        raise ValueError(f"{origin}: field number {bad} outside 1..{num_fields}")
    if (vals < 0).any():
        raise ValueError(f"{origin}: raw-CTR ids must be non-negative")
    if (vals != np.floor(vals)).any():
        raise ValueError(f"{origin}: raw-CTR ids must be integers (found fractional value)")
    if (vals >= float(1 << 24)).any():
        raise ValueError(
            f"{origin}: raw-CTR id exceeds float32's exact-integer range "
            "(2^24); the id was already corrupted when it was encoded")
    raw_ids = np.full((n, num_fields), -1, np.int64)
    raw_ids[np.repeat(np.arange(n), num_fields), cols] = vals.astype(np.int64)
    if (raw_ids < 0).any():
        bad = int(np.argmax((raw_ids < 0).any(axis=1)))
        raise ValueError(
            f"{origin}: row {bad} repeats a field number (every field must "
            "appear exactly once)")
    return raw_ids


def read_raw_ctr_file(path: str, num_fields: int, *, max_rows: int | None = None,
                      stride: int = 1):
    """One raw-CTR shard -> ``(raw_ids (N, F) int64, y (N,) int32)``;
    ``max_rows`` / ``stride`` keep every ``stride``-th line, at most
    ``max_rows`` of them, without parsing the rest."""
    # num_features=None keeps every column, so a row with extra fields
    # fails the checks instead of being cut to a passing width
    if max_rows is None and stride == 1:
        (row_ptr, cols, vals), y = parse_libsvm_file(path, None, dense=False)
    else:
        stop = None if max_rows is None else max_rows * stride
        with open(path) as f:
            lines = list(itertools.islice(f, 0, stop, stride))
        (row_ptr, cols, vals), y = parse_libsvm_lines(lines, None, dense=False)
    return csr_to_raw_ids(row_ptr, cols, vals, num_fields, origin=path), y
