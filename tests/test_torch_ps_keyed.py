"""The port's keyed parameter-server path on the CPU, against the JAX
package's: the keyed gradients, the padded-COO and row-blocked
iterators, the client's ``vals_per_key`` ops (on real server processes,
the port's and the JAX package's), and ``run_ps_local`` for
``sparse_lr``, ``sparse_softmax`` and ``blocked_lr`` in sync (BSP) and
async (Hogwild) mode, at D = 4,096 buckets, 8 fields, 2 workers.

Tolerances: the host numpy gradients are the JAX package's functions,
copied, so they are held equal; the torch CPU gradients rtol 1e-5 (f32
``index_add_`` where numpy adds in f64 or in another order); training on
the numpy backend rtol 1e-6, on torch CPU rtol 1e-5 (atol 1e-6 for the
weights that sum to nearly zero); iterator batches byte for byte.
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.train import ps_trainer as jax_ps
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data import hashing
from distlr_tpu_torch.data.iterator import BlockedDataIter, SparseDataIter
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.train import ps_trainer
from distlr_tpu_torch.train.ps_trainer import run_ps_local

D, FIELDS, VOCAB, K, R = 4096, 8, 500, 4, 8
EVAL_LINE = re.compile(r"^\d\d:\d\d:\d\d (Iteration \d+, accuracy: \S+)$", re.M)
RESOLVED = re.compile(r"block_size auto: resolved to (?:scalar-equivalent )?(R=\d+)")


def _write_multiclass_ctr(d: str, n: int, seed: int) -> None:
    """Hashed one-hot CTR rows (FIELDS fields over D buckets) with K
    classes from a planted (D, K) table, as libsvm shards: 2 train parts
    and a test part."""
    _, cols, vals, _, _ = hashing.make_ctr_dataset(n, FIELDS, VOCAB, D, seed=seed)
    rng = np.random.default_rng(seed + 1)
    w_true = rng.standard_normal((D, K)).astype(np.float32)
    y = np.argmax(w_true[cols].sum(axis=1) + rng.gumbel(size=(n, K)), axis=1)
    n_test = n // 5
    splits = {("test", 1): slice(0, n_test)}
    half = (n - n_test) // 2
    for p in range(2):
        splits[("train", p + 1)] = slice(n_test + p * half, n_test + (p + 1) * half)
    for (split, part), sl in splits.items():
        os.makedirs(os.path.join(d, split), exist_ok=True)
        with open(os.path.join(d, split, f"part-{part:03d}"), "w") as f:
            for c, v, label in zip(cols[sl], vals[sl], y[sl]):
                uniq, inv = np.unique(c, return_inverse=True)
                summed = np.zeros(len(uniq), np.float32)
                np.add.at(summed, inv, v)
                f.write(f"{label} " + " ".join(f"{u + 1}:{s:g}" for u, s in zip(uniq, summed)
                                               if s != 0) + "\n")


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("keyed")
    dirs = {f: str(root / f) for f in ("sparse_lr", "sparse_softmax", "blocked_lr")}
    hashing.write_ctr_shards(dirs["sparse_lr"], 1000, FIELDS, VOCAB, D, 2, seed=3)
    _write_multiclass_ctr(dirs["sparse_softmax"], 1000, seed=4)
    # rows drawn from 64 distinct field tuples: the conjunction rows recur,
    # so a blocked table has something to learn (i.i.d. fields give none)
    hashing.write_raw_ctr_shards(dirs["blocked_lr"], 1000, FIELDS, VOCAB, 2, seed=5,
                                 num_distinct_tuples=64)
    return dirs


def _family_kw(family: str) -> dict:
    if family == "sparse_softmax":
        return {"model": family, "num_classes": K}
    if family == "blocked_lr":
        return {"model": family, "block_size": R}
    return {"model": family}


# --- the keyed gradients -----------------------------------------------------

def _grad_inputs(family: str, seed: int):
    """A keyed batch as the round builds it: the unique slice's weights,
    the positions, the values (with COO padding at key 0), labels, mask."""
    rng = np.random.default_rng(seed)
    B = 64
    mask = np.ones(B, bool)
    mask[-5:] = False
    if family == "blocked_lr":
        raw = rng.integers(0, VOCAB, size=(B, FIELDS))
        ids, vals = hashing.encode_blocked(raw, D // R, R, seed=seed)
        vals = vals.copy()
        vals[:3, -1] = 0.0  # padded groups
    else:
        ids = rng.integers(0, 300, size=(B, 10)).astype(np.int32)
        vals = rng.standard_normal((B, 10)).astype(np.float32)
        ids[:, -2:], vals[:, -2:] = 0, 0.0  # COO padding
    ub, pos = np.unique(ids, return_inverse=True)
    pos = pos.reshape(ids.shape)
    width = {"sparse_lr": 1, "sparse_softmax": K, "blocked_lr": R}[family]
    shape = (len(ub),) if width == 1 else (len(ub), width)
    w_u = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    y = rng.integers(0, K if family == "sparse_softmax" else 2, size=B).astype(np.int32)
    return w_u, pos, vals, y, mask


GRAD_NAMES = {"sparse_lr": "_sparse_batch_grad", "sparse_softmax": "_sparse_softmax_batch_grad",
              "blocked_lr": "_blocked_batch_grad"}


@pytest.mark.parametrize("family", list(GRAD_NAMES))
@pytest.mark.parametrize("l2_c,scale", [(0.0, False), (0.3, False), (0.3, True)])
class TestKeyedGradients:
    def test_numpy_copy_equals_jax(self, family, l2_c, scale):
        args = _grad_inputs(family, 11)
        ours = getattr(ps_trainer, GRAD_NAMES[family])(*args, l2_c, scale)
        theirs = getattr(jax_ps, GRAD_NAMES[family])(*args, l2_c, scale)
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)

    def test_torch_cpu_matches_jax(self, family, l2_c, scale):
        args = _grad_inputs(family, 12)
        theirs = getattr(jax_ps, GRAD_NAMES[family])(*args, l2_c, scale)
        fn = getattr(ps_trainer, GRAD_NAMES[family] + "_torch")
        ours = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), l2_c, scale)
        assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-7)


def test_lazy_l2_discounts_padding_like_jax():
    """Key 0 sits in every batch through COO padding: with only padded
    values there, it must not decay (the active mask), on both paths."""
    w_u, pos, vals, y, mask = _grad_inputs("sparse_lr", 13)
    vals = np.where(pos == 0, 0.0, vals).astype(np.float32)
    g_np = ps_trainer._sparse_batch_grad(w_u, pos, vals, y, mask, 1.0, False)
    g_t = ps_trainer._sparse_batch_grad_torch(
        *(torch.from_numpy(a) for a in (w_u, pos, vals, y, mask)), 1.0, False)
    assert g_np[0] == 0.0 and float(g_t[0]) == 0.0
    np.testing.assert_array_equal(g_np, jax_ps._sparse_batch_grad(w_u, pos, vals, y, mask,
                                                                   1.0, False))


@pytest.mark.parametrize("width", [1, 4, 16])
def test_expand_block_keys_equals_jax(width):
    rows = np.array([0, 3, 7, 250], np.int64)
    ours = ps_trainer._expand_block_keys(rows, width)
    theirs = jax_ps._expand_block_keys(rows, width)
    assert ours.dtype == theirs.dtype == np.uint64
    np.testing.assert_array_equal(ours, theirs)


# --- the iterators -----------------------------------------------------------

def _same_batches(ours, theirs):
    ours.reset()
    theirs.reset()
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) and ours.num_batches == theirs.num_batches
    for x, z in zip(a, b):
        assert len(x) == len(z)
        for u, v in zip(x, z):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


class TestIterators:
    @pytest.mark.parametrize("family", ["sparse_lr", "sparse_softmax"])
    @pytest.mark.parametrize("batch_size,kw", [(-1, {}), (64, {}), (64, {"wrap_compat": True}),
                                               (100, {"nnz_max": 5})])
    def test_sparse_iter_batches_equal_jax(self, data_dirs, family, batch_size, kw):
        from distlr_tpu.data.iterator import SparseDataIter as JaxSparseDataIter

        path = os.path.join(data_dirs[family], "train", "part-001")
        kw = dict(kw, multiclass=family == "sparse_softmax")
        _same_batches(SparseDataIter.from_file(path, D, batch_size, **kw),
                      JaxSparseDataIter.from_file(path, D, batch_size, **kw))

    @pytest.mark.parametrize("block_size,groups,batch_size", [(8, 0, -1), (8, 0, 64), (4, 3, 50)])
    def test_blocked_iter_batches_equal_jax(self, data_dirs, block_size, groups, batch_size):
        from distlr_tpu.data.iterator import BlockedDataIter as JaxBlockedDataIter

        path = os.path.join(data_dirs["blocked_lr"], "test", "part-001")
        args = (path, FIELDS, D // block_size, block_size, batch_size)
        kw = {"seed": 7, "num_groups": groups}
        _same_batches(BlockedDataIter.from_file(*args, **kw),
                      JaxBlockedDataIter.from_file(*args, **kw))

    def test_shape_mismatch_refused(self):
        with pytest.raises(ValueError, match="cols"):
            SparseDataIter(np.zeros((4, 3), np.int32), np.zeros((4, 2), np.float32), np.zeros(4))
        with pytest.raises(ValueError, match="blocks"):
            BlockedDataIter(np.zeros((4, 3), np.int32), np.zeros((4, 2, 8), np.float32),
                            np.zeros(4))


# --- the client's keyed ops --------------------------------------------------

class TestKeyedOps:
    """Keyed (subset) Push/Pull, ps-lite's sliced keys (tests/test_ps.py's
    TestKeyedOps, on the port's servers and client)."""

    def test_keyed_push_pull_across_ranges(self):
        dim = 10
        with ServerGroup(2, 1, dim, learning_rate=1.0, sync=False) as group, \
                KVWorker(group.hosts, dim, timeout_ms=20_000) as kv:
            kv.wait(kv.push(np.zeros(dim, np.float32)))  # init
            # touched keys straddle the two server ranges [0,5) and [5,10)
            keys = np.array([1, 4, 5, 9], np.uint64)
            kv.wait(kv.push(np.array([1, 2, 3, 4], np.float32), keys=keys))
            expect = np.zeros(dim, np.float32)
            expect[[1, 4, 5, 9]] = [-1, -2, -3, -4]  # async applies w -= lr*g
            np.testing.assert_allclose(kv.pull(), expect)
            np.testing.assert_allclose(kv.pull(keys=np.array([0, 4, 9], np.uint64)),
                                       [0, -2, -4])
            kv.shutdown_servers()

    def test_sync_keyed_push_skipping_a_range_keeps_barrier(self):
        """BSP: a keyed push whose slice for some server is EMPTY must still
        count toward that server's barrier (the client sends an empty
        'present' vote), or peers that did touch the range deadlock."""
        dim = 10  # ranges [0,5) and [5,10)
        with ServerGroup(2, 2, dim, learning_rate=1.0, sync=True) as group:
            kv0 = KVWorker(group.hosts, dim, client_id=0, timeout_ms=20_000)
            kv1 = KVWorker(group.hosts, dim, client_id=1, timeout_ms=20_000)
            kv0.wait(kv0.push(np.zeros(dim, np.float32)))  # init (full)
            done = []

            def push0():  # touches ONLY server 0's range
                kv0.wait(kv0.push(np.array([2.0], np.float32), keys=np.array([1], np.uint64)))
                done.append(0)

            th = threading.Thread(target=push0, daemon=True)
            th.start()
            # touches ONLY server 1's range
            kv1.wait(kv1.push(np.array([4.0], np.float32), keys=np.array([7], np.uint64)))
            th.join(timeout=15)
            assert done == [0], "sync keyed push deadlocked across ranges"
            expect = np.zeros(dim, np.float32)
            expect[1], expect[7] = -1.0, -2.0  # the correct mean: w -= lr * g/2
            np.testing.assert_allclose(kv0.pull(), expect)
            kv0.close()
            kv1.close()


def _expanded(rows, width):
    return (rows[:, None] * width + np.arange(width, dtype=np.uint64)).reshape(-1)


class TestValsPerKey:
    """``vals_per_key`` (ps-lite's uniform ``lens``): one u64 row id
    addresses R consecutive flat slots, with the semantics of R expanded
    keys (tests/test_ps.py's TestValsPerKey, on the port's servers)."""

    def test_pull_matches_expanded(self):
        # dim=64 over 2 servers -> ranges [0,32) [32,64), R=8-aligned
        with ServerGroup(2, 1, dim=64) as sg, KVWorker(sg.hosts, 64) as kv:
            kv.push(np.arange(64, dtype=np.float32))
            rows = np.array([0, 3, 4, 7], dtype=np.uint64)  # crosses the boundary
            np.testing.assert_array_equal(kv.pull(keys=rows, vals_per_key=8),
                                          kv.pull(keys=_expanded(rows, 8)))

    def test_push_matches_expanded(self):
        def run(use_vpk):
            with ServerGroup(1, 1, dim=64, sync=False, learning_rate=1.0) as sg, \
                    KVWorker(sg.hosts, 64) as kv:
                kv.push(np.zeros(64, np.float32))  # init
                rows = np.array([1, 5], dtype=np.uint64)
                g = np.arange(16, dtype=np.float32)
                if use_vpk:
                    kv.push(g, keys=rows, vals_per_key=8)
                else:
                    kv.push(g, keys=_expanded(rows, 8))
                return kv.pull()

        np.testing.assert_array_equal(run(True), run(False))

    def test_push_pull_fused_vpk(self):
        with ServerGroup(1, 1, dim=32, sync=False, learning_rate=1.0) as sg, \
                KVWorker(sg.hosts, 32) as kv:
            kv.push(np.zeros(32, np.float32))  # init
            out = kv.push_pull(np.ones(8, np.float32), keys=np.array([2], dtype=np.uint64),
                               vals_per_key=8)
            np.testing.assert_allclose(out, -np.ones(8))  # w -= 1*g
            full = kv.pull()
            np.testing.assert_allclose(full[16:24], -np.ones(8))
            assert np.all(full[:16] == 0) and np.all(full[24:] == 0)

    def test_sync_merge_mixes_vpk_and_expanded(self):
        """Two workers of one BSP round, one pushing row keys and one the
        expanded keys of the SAME slots: one merge path."""
        with ServerGroup(1, 2, dim=32, sync=True, learning_rate=1.0) as sg:
            kv0 = KVWorker(sg.hosts, 32, client_id=0)
            kv1 = KVWorker(sg.hosts, 32, client_id=1)
            kv0.push(np.zeros(32, np.float32))  # init
            done = []

            def w0():
                kv0.push(np.full(8, 2.0, np.float32), keys=np.array([1], dtype=np.uint64),
                         vals_per_key=8)
                done.append(0)

            th = threading.Thread(target=w0)
            th.start()
            kv1.push(np.full(8, 4.0, np.float32), keys=np.arange(8, 16, dtype=np.uint64))
            th.join(timeout=10)
            assert done
            np.testing.assert_allclose(kv0.pull()[8:16], np.full(8, -3.0))  # -1 * (2+4)/2
            kv0.close()
            kv1.close()

    def test_supports_vals_per_key_alignment(self):
        # dim=96 over 2 servers -> boundary 48: aligned for R=8, not R=32
        with ServerGroup(2, 1, dim=96) as sg, KVWorker(sg.hosts, 96) as kv, \
                JaxKVWorker(sg.hosts, 96, client_id=1) as jkv:
            for vpk in (1, 8, 32, 5):
                assert kv.supports_vals_per_key(vpk) == jkv.supports_vals_per_key(vpk)
            assert kv.supports_vals_per_key(8) and not kv.supports_vals_per_key(32)
            kv.push(np.zeros(96, np.float32))
            # the native client refuses an unaligned vpk op with a named error
            with pytest.raises(OSError, match="aligned|expanded"):
                kv.pull(keys=np.array([0], dtype=np.uint64), vals_per_key=32)

    def test_dense_default_keys_reject_vpk(self):
        """keys=None is the FLAT dense key set: with vals_per_key > 1 it
        raises instead of reinterpreting flat ids as row ids."""
        with ServerGroup(1, 1, dim=64) as sg, KVWorker(sg.hosts, 64) as kv:
            kv.push(np.zeros(64, np.float32))
            with pytest.raises(ValueError, match="row keys"):
                kv.pull(vals_per_key=8)
            with pytest.raises(ValueError, match="row keys"):
                kv.push(np.zeros(64, np.float32), vals_per_key=8)
            with pytest.raises(ValueError, match="row keys"):
                kv.push_pull(np.zeros(64, np.float32), vals_per_key=8)

    def test_row_key_range_and_length_validation(self):
        with ServerGroup(1, 1, dim=64) as sg, KVWorker(sg.hosts, 64) as kv:
            kv.push(np.zeros(64, np.float32))
            with pytest.raises(ValueError, match=r"out of range .*vals_per_key=8 -> 8 rows"):
                kv.pull(keys=np.array([8], dtype=np.uint64), vals_per_key=8)
            with pytest.raises(ValueError, match="ascending"):
                kv.pull(keys=np.array([3, 1], dtype=np.uint64), vals_per_key=8)
            with pytest.raises(ValueError, match="vals vs 2 keys x vals_per_key 8"):
                kv.push(np.zeros(15, np.float32), keys=np.array([1, 2], np.uint64),
                        vals_per_key=8)

    @pytest.mark.parametrize("num_servers,vpk", [(2, 8), (3, 1), (1, 4)])
    def test_pull_chunked_and_rows_into_equal_jax(self, num_servers, vpk):
        """``pull_chunked(vals_per_key=)`` and ``pull_rows_into`` return the
        JAX client's bytes on one group."""
        dim = 96
        init = np.linspace(-3, 3, dim).astype(np.float32)
        with ServerGroup(num_servers, 1, dim=dim) as sg, KVWorker(sg.hosts, dim) as kv, \
                JaxKVWorker(sg.hosts, dim, client_id=1) as jkv:
            kv.push_init(init)
            for chunk in (5, 1 << 16):
                got = kv.pull_chunked(vals_per_key=vpk, chunk_rows=chunk)
                np.testing.assert_array_equal(got, init)
                np.testing.assert_array_equal(
                    got, jkv.pull_chunked(vals_per_key=vpk, chunk_rows=chunk))
            rows = np.array([0, 2, dim // vpk - 1], np.uint64)
            np.testing.assert_array_equal(kv.pull_chunked(rows, vals_per_key=vpk, chunk_rows=2),
                                          jkv.pull_chunked(rows, vals_per_key=vpk,
                                                           chunk_rows=2))
            ours, theirs = np.zeros(dim, np.float32), np.zeros(dim, np.float32)
            assert kv.pull_rows_into(ours, rows, vals_per_key=vpk, chunk_rows=2) == 3
            assert jkv.pull_rows_into(theirs, rows, vals_per_key=vpk, chunk_rows=2) == 3
            np.testing.assert_array_equal(ours, theirs)
            expect = np.zeros((dim // vpk, vpk), np.float32)
            expect[rows.astype(np.int64)] = init.reshape(-1, vpk)[rows.astype(np.int64)]
            np.testing.assert_array_equal(ours, expect.reshape(-1))
            assert kv.pull_rows_into(ours, np.array([], np.uint64), vals_per_key=vpk) == 0
            with pytest.raises(ValueError, match="C-contiguous float32"):
                kv.pull_rows_into(np.zeros(dim, np.float64), rows, vals_per_key=vpk)

    def test_port_client_talks_vpk_frames_to_the_jax_packages_server(self):
        """The port's client against the JAX package's native server: the
        vals_per_key frames are the JAX client's byte for byte, so a keyed
        push and pull land as that client's do."""
        with JaxServerGroup(2, 1, dim=64, sync=False, learning_rate=1.0) as sg, \
                KVWorker(sg.hosts, 64) as kv, JaxKVWorker(sg.hosts, 64, client_id=1) as jkv:
            kv.push_init(np.zeros(64, np.float32))
            rows = np.array([1, 4, 6], np.uint64)  # 8-lane rows on both ranges
            g = np.arange(24, dtype=np.float32)
            kv.push(g, keys=rows, vals_per_key=8)
            np.testing.assert_array_equal(kv.pull(keys=rows, vals_per_key=8), -g)
            np.testing.assert_array_equal(jkv.pull(keys=rows, vals_per_key=8), -g)
            out = kv.push_pull(np.ones(8, np.float32), keys=rows[:1], vals_per_key=8)
            np.testing.assert_array_equal(out, -g[:8] - 1)
            np.testing.assert_array_equal(kv.pull(), jkv.pull())


# --- training ----------------------------------------------------------------

def _cfgs(d, family, **kw):
    common = dict(data_dir=d, num_feature_dim=D, num_workers=2, num_servers=2,
                  num_iteration=4, learning_rate=0.5, l2_c=0.0, batch_size=100,
                  test_interval=2, sync_mode=True, ps_timeout_ms=60_000, **_family_kw(family))
    common.update(kw)
    return Config(device="cpu", **common), JaxConfig(**common)


def _run_both(ours_cfg, jax_cfg, capsys):
    ours_ev, jax_ev = [], []
    capsys.readouterr()
    ours = run_ps_local(ours_cfg, eval_fn=lambda e, a: ours_ev.append((e, a)))
    ref = jax_ps.run_ps_local(jax_cfg, eval_fn=lambda e, a: jax_ev.append((e, a)))
    return ours, ref, ours_ev, jax_ev


FAMILIES = ("sparse_lr", "sparse_softmax", "blocked_lr")


class TestTrainingParityWithJax:
    """``run_ps_local`` sync, 2 workers, against the JAX package's: 2
    servers (vals_per_key rows align) and 3 (rows straddle the boundaries:
    expanded keys)."""

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("num_servers", [2, 3])
    @pytest.mark.parametrize("backend,rtol,atol", [("numpy", 1e-6, 1e-7), ("cpu", 1e-5, 1e-6)])
    def test_sync_weights_and_evals(self, data_dirs, capsys, family, num_servers, backend,
                                    rtol, atol):
        ours_cfg, jax_cfg = _cfgs(data_dirs[family], family, num_servers=num_servers,
                                  ps_compute_backend=backend, l2_c=0.05)
        ours, ref, ours_ev, jax_ev = _run_both(ours_cfg, jax_cfg, capsys)
        np.testing.assert_allclose(ours[0], ours[1], rtol=0, atol=0)  # one BSP state
        for a, b in zip(ours, ref):
            assert a.shape == b.shape == (ps_trainer.ps_param_dim(ours_cfg),)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        assert [e for e, _ in ours_ev] == [e for e, _ in jax_ev] == [2, 4]
        np.testing.assert_allclose([a for _, a in ours_ev], [a for _, a in jax_ev], atol=1e-6)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_both_print_the_same_eval_lines(self, data_dirs, capsys, family):
        ours_cfg, jax_cfg = _cfgs(data_dirs[family], family, ps_compute_backend="numpy")
        capsys.readouterr()
        run_ps_local(ours_cfg)
        ours = EVAL_LINE.findall(capsys.readouterr().out)
        jax_ps.run_ps_local(jax_cfg)
        theirs = EVAL_LINE.findall(capsys.readouterr().out)
        assert ours == theirs and len(ours) == 2

    @pytest.mark.parametrize("family", ["sparse_softmax", "blocked_lr"])
    def test_expanded_keys_give_the_vpk_weights(self, data_dirs, capfd, family):
        """3 servers put a boundary inside a row (expanded per-lane keys), 2
        do not (vals_per_key rows): the same slots, the same weights."""
        runs = {}
        for servers in (2, 3):
            cfg = _cfgs(data_dirs[family], family, num_servers=servers,
                        ps_compute_backend="numpy")[0]
            capfd.readouterr()
            runs[servers] = run_ps_local(cfg)
            err = capfd.readouterr().err
            width = K if family == "sparse_softmax" else R
            expect = f"vals_per_key={width}" if servers == 2 else "expanded per-lane keys"
            assert f"rank 0 keyed wire encoding: {expect}" in err, err[-2000:]
        np.testing.assert_array_equal(runs[2][0], runs[3][0])

    @pytest.mark.parametrize("family", FAMILIES)
    def test_async_single_worker_matches(self, data_dirs, capsys, family):
        """One async worker has no races: its Hogwild run equals the JAX
        package's."""
        ours_cfg, jax_cfg = _cfgs(data_dirs[family], family, ps_compute_backend="numpy",
                                  sync_mode=False, num_workers=1)
        ours, ref, ours_ev, jax_ev = _run_both(ours_cfg, jax_cfg, capsys)
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-6, atol=1e-7)
        assert ours_ev == pytest.approx(jax_ev)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_async_two_workers_learn(self, data_dirs, family):
        report = {}
        cfg = _cfgs(data_dirs[family], family, sync_mode=False, num_iteration=6,
                    test_interval=6)[0]
        run_ps_local(cfg.replace(num_iteration=1, test_interval=1), report=report)
        ll_1 = report[0]["test_logloss"]
        out = run_ps_local(cfg, report=report)
        assert all(np.isfinite(w).all() for w in out)
        assert report[0]["test_logloss"] < ll_1
        steps = 6 * -(-400 // 100)
        assert [report[r]["steps"] for r in (0, 1)] == [steps, steps]
        assert report[0]["group_pushes"] == 2 * steps + 1  # and the seeding push


class TestKeyedWorker:
    def test_report_counts_rows_and_wire_bytes(self, data_dirs):
        report = {}
        cfg = _cfgs(data_dirs["blocked_lr"], "blocked_lr", num_iteration=1)[0]
        run_ps_local(cfg, report=report)
        r0 = report[0]
        assert r0["vals_per_key"] == R
        assert r0["steps"] == r0["grad_count"] == r0["push_count"] == r0["prep_count"] == 4
        assert r0["pull_count"] == 4 + 1  # and the final pull
        assert r0["wire_bytes_per_round"] == r0["keyed_rows_per_round"] * (8 + 4 * R)
        assert 0 < r0["keyed_rows_per_round"] <= 100 * FIELDS

    @pytest.mark.parametrize("family", ["sparse_lr", "blocked_lr"])
    def test_q1_refused_like_jax(self, data_dirs, family, monkeypatch):
        """Q1 (the last worker's gradient) is a dense-reference quirk: the
        keyed families refuse it with the JAX package's message, before any
        server starts."""
        ours_cfg, jax_cfg = _cfgs(data_dirs[family], family, compat_mode="reference")
        assert ours_cfg.sync_last_gradient and jax_cfg.sync_last_gradient
        with pytest.raises(ValueError, match="sync_last_gradient") as theirs:
            jax_ps.run_ps_local(jax_cfg)
        monkeypatch.setattr(ServerGroup, "start", lambda self: pytest.fail("servers spawned"))
        with pytest.raises(ValueError, match="sync_last_gradient") as ours:
            run_ps_local(ours_cfg)
        assert str(ours.value) == str(theirs.value)

    def test_lazy_l2_warning(self, data_dirs, capfd):
        cfg = _cfgs(data_dirs["sparse_lr"], "sparse_lr", l2_c=0.1, num_iteration=1,
                    test_interval=0)[0]
        capfd.readouterr()
        run_ps_local(cfg)
        assert "applies L2 lazily" in capfd.readouterr().err

    def test_unresolved_auto_block_size_refused(self, data_dirs):
        cfg = _cfgs(data_dirs["blocked_lr"], "blocked_lr", block_size=0)[0]
        with pytest.raises(ValueError, match="auto"):
            run_ps_local(cfg)


class TestCLI:
    def test_launch_ps_blocked_auto_through_both_clis(self, tmp_path, capfd):
        """One ``launch ps --model blocked_lr --block-size auto`` command
        line through the JAX package's CLI and the port's: the same R, the
        same eval lines, the same models."""
        import shutil

        from distlr_tpu import launch as jax_launch
        from distlr_tpu_torch import launch

        # rows drawn from 8 distinct field tuples: each recurs 50 times in a
        # 400-row shard, so auto resolves a block wider than 1
        dirs = {"jax": str(tmp_path / "jax"), "ours": str(tmp_path / "ours")}
        hashing.write_raw_ctr_shards(dirs["jax"], 1000, FIELDS, VOCAB, 2, seed=6,
                                     num_distinct_tuples=8)
        shutil.copytree(dirs["jax"], dirs["ours"])
        argv = ["ps", "--model", "blocked_lr", "--block-size", "auto", "--num-feature-dim",
                str(D), "--num-workers", "2", "--num-servers", "2", "--num-iteration", "2",
                "--batch-size", "100", "--test-interval", "1", "--learning-rate", "0.5",
                "--l2-c", "0", "--ps-compute-backend", "numpy"]
        capfd.readouterr()
        assert jax_launch.main([*argv, "--data-dir", dirs["jax"]]) == 0
        out, err = capfd.readouterr()
        theirs, r_theirs = EVAL_LINE.findall(out), re.findall(RESOLVED, err)
        assert launch.main([*argv, "--data-dir", dirs["ours"], "--device", "cpu"]) == 0
        out, err = capfd.readouterr()
        ours, r_ours = EVAL_LINE.findall(out), re.findall(RESOLVED, err)
        assert ours == theirs and len(ours) == 2
        assert r_ours == r_theirs and r_ours[0] != "R=1", (r_ours, r_theirs, err)
        for part in ("part-001", "part-002"):
            a, b = (np.loadtxt(os.path.join(dirs[n], "models", part), skiprows=1)
                    for n in ("ours", "jax"))
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
