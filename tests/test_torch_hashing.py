"""The port's copy of the hashing module against the JAX package's, bit for
bit: the mixers, both encodings, the block-size advisor, the synthetic CTR
generator, and the files both shard writers produce.  Also the port's
libsvm parser on the CSR and multiclass paths the sparse families read.
"""

import os

import numpy as np
import pytest

from distlr_tpu.data import hashing as jh
from distlr_tpu.data import libsvm as jlibsvm
from distlr_tpu_torch.data import hashing as th
from distlr_tpu_torch.data import libsvm as tlibsvm


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


class TestMixers:
    def test_splitmix64(self):
        x = np.random.default_rng(0).integers(0, 2**63, size=1000, dtype=np.int64).astype(np.uint64)
        x[:3] = [0, 1, 2**64 - 1]
        _same(th.splitmix64(x), jh.splitmix64(x))

    @pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
    @pytest.mark.parametrize("fields", [False, True])
    def test_hash_buckets(self, seed, fields):
        rng = np.random.default_rng(1)
        ids = rng.integers(0, 10**9, size=(50, 6))
        fid = np.broadcast_to(np.arange(6), ids.shape) if fields else None
        _same(th.hash_buckets(ids, 1000, seed=seed, field_ids=fid),
              jh.hash_buckets(ids, 1000, seed=seed, field_ids=fid))


class TestBlocked:
    @pytest.mark.parametrize("num_fields,block_size,num_groups",
                             [(21, 8, 0), (21, 8, 3), (21, 32, 0), (21, 32, 4), (6, 4, 6), (5, 8, 0)])
    def test_groups_and_encoding(self, num_fields, block_size, num_groups):
        _same(th.split_field_groups(num_fields, block_size, num_groups),
              jh.split_field_groups(num_fields, block_size, num_groups))
        _same(th.default_field_groups(num_fields, block_size),
              jh.default_field_groups(num_fields, block_size))
        raw = np.random.default_rng(2).integers(0, 50, size=(40, num_fields))
        _same(th.encode_blocked(raw, 512, block_size, seed=3, num_groups=num_groups),
              jh.encode_blocked(raw, 512, block_size, seed=3, num_groups=num_groups))

    def test_raw_vals_and_explicit_groups(self):
        rng = np.random.default_rng(4)
        raw = rng.integers(0, 9, size=(30, 5))
        vals = rng.standard_normal((30, 5)).astype(np.float32)
        groups = np.array([[0, 3, -1], [4, 1, 2]])
        _same(th.hash_group_blocks(raw, groups, 97, seed=1, raw_vals=vals),
              jh.hash_group_blocks(raw, groups, 97, seed=1, raw_vals=vals))

    def test_bad_group_count_raises_alike(self):
        for mod in (th, jh):
            with pytest.raises(ValueError, match="outside"):
                mod.split_field_groups(21, 8, 30)

    def test_uniform_blocked_batch(self):
        a = th.make_uniform_blocked_batch(np.random.default_rng(5), 64, 21, 1000, 8)
        b = jh.make_uniform_blocked_batch(np.random.default_rng(5), 64, 21, 1000, 8)
        _same(a, b)


class TestAdvisor:
    @pytest.mark.parametrize("vocab,tuples,buckets", [
        (10**6, None, 1 << 20), (1000, 64, 1 << 16), (1000, 512, 1 << 14), (4, None, 1 << 18)])
    def test_suggestions_match(self, vocab, tuples, buckets):
        raw, *_ = th.make_ctr_dataset(4000, 16, vocab, 1024, seed=6, num_distinct_tuples=tuples)
        assert th.suggest_block_size(raw, buckets) == jh.suggest_block_size(raw, buckets)
        assert th.suggest_blocking(raw, buckets) == jh.suggest_blocking(raw, buckets)
        assert (th.suggest_blocking(raw, buckets, num_groups=4)
                == jh.suggest_blocking(raw, buckets, num_groups=4))

    def test_infeasible_pinned_groups_raise_alike(self):
        raw = np.zeros((10, 40), np.int64)
        for mod in (th, jh):
            with pytest.raises(ValueError, match="infeasible"):
                mod.suggest_blocking(raw, 1 << 16, (8,), num_groups=2)

    @pytest.mark.parametrize("num_groups", [0, 3])
    def test_resolve_auto_block_size(self, tmp_path, num_groups):
        th.write_raw_ctr_shards(str(tmp_path), 3000, 8, 500, 2, seed=2, num_distinct_tuples=64)
        got = th.resolve_auto_block_size(str(tmp_path), 0, 1 << 16, sample_rows=500,
                                         num_groups=num_groups)
        want = jh.resolve_auto_block_size(str(tmp_path), 0, 1 << 16, sample_rows=500,
                                          num_groups=num_groups)
        assert got == want

    def test_auto_without_shards_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="explicit --block-size"):
            th.resolve_auto_block_size(str(tmp_path), 8, 1 << 16)


class TestCTRData:
    @pytest.mark.parametrize("kw", [
        {}, {"signed": True}, {"noise": 0.5}, {"num_distinct_tuples": 17},
        {"center_logits": True, "seed": 3}])
    def test_make_ctr_dataset(self, kw):
        _same(th.make_ctr_dataset(300, 7, 1000, 4096, **kw),
              jh.make_ctr_dataset(300, 7, 1000, 4096, **kw))

    @pytest.mark.parametrize("nnz_max", [None, 2, 9])
    def test_csr_to_padded_coo(self, nnz_max):
        row_ptr = np.array([0, 3, 3, 8, 9])
        cols = np.arange(9, dtype=np.int32) * 3
        vals = np.linspace(-1, 1, 9).astype(np.float32)
        _same(th.csr_to_padded_coo(row_ptr, cols, vals, nnz_max=nnz_max),
              jh.csr_to_padded_coo(row_ptr, cols, vals, nnz_max=nnz_max))

    def test_write_ctr_shards_same_bytes(self, tmp_path):
        a, b = tmp_path / "torch", tmp_path / "jax"
        ma = th.write_ctr_shards(str(a), 500, 6, 300, 2048, 3, seed=4)
        jh.write_ctr_shards(str(b), 500, 6, 300, 2048, 3, seed=4)
        files = _tree_bytes(a)
        assert files == _tree_bytes(b)
        assert {"train/part-001", "train/part-003", "test/part-001", "w_true.npy"} <= set(files)
        assert len(ma["train_parts"]) == 3

    @pytest.mark.parametrize("tuples", [None, 40])
    def test_write_raw_ctr_shards_same_bytes(self, tmp_path, tuples):
        a, b = tmp_path / "torch", tmp_path / "jax"
        ma = th.write_raw_ctr_shards(str(a), 400, 5, 900, 2, seed=1, num_distinct_tuples=tuples)
        mb = jh.write_raw_ctr_shards(str(b), 400, 5, 900, 2, seed=1, num_distinct_tuples=tuples)
        assert _tree_bytes(a) == _tree_bytes(b)
        assert ma["meta"] == mb["meta"] == th.read_ctr_meta(str(a))

    @pytest.mark.parametrize("max_rows,stride", [(None, 1), (50, 3), (1000, 2)])
    def test_read_raw_ctr_file(self, tmp_path, max_rows, stride):
        th.write_raw_ctr_shards(str(tmp_path), 400, 5, 900, 1, seed=1)
        p = str(tmp_path / "train" / "part-001")
        _same(th.read_raw_ctr_file(p, 5, max_rows=max_rows, stride=stride),
              jh.read_raw_ctr_file(p, 5, max_rows=max_rows, stride=stride))

    @pytest.mark.parametrize("line,match", [
        ("1 1:3 2:4\n", "has 2 fields"), ("1 1:3 2:4 9:1\n", "outside 1..3"),
        ("1 1:3 2:-4 3:1\n", "non-negative"), ("1 1:3 2:4.5 3:1\n", "integers"),
        ("1 1:3 2:16777216 3:1\n", "exact-integer"), ("1 1:3 1:4 3:1\n", "repeats")])
    def test_malformed_raw_rows_raise_alike(self, tmp_path, line, match):
        p = tmp_path / "bad"
        p.write_text("1 1:0 2:1 3:2\n" + line)
        for mod in (th, jh):
            with pytest.raises(ValueError, match=match):
                mod.read_raw_ctr_file(str(p), 3)

    def test_resolve_ctr_fields(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="ctr_meta.json"):
            th.resolve_ctr_fields(str(tmp_path), 0)
        assert th.resolve_ctr_fields(str(tmp_path), 4) == 4
        th.write_raw_ctr_shards(str(tmp_path), 100, 5, 900, 1)
        assert th.resolve_ctr_fields(str(tmp_path), 0) == jh.resolve_ctr_fields(str(tmp_path), 0) == 5
        with pytest.raises(ValueError, match="conflicts"):
            th.resolve_ctr_fields(str(tmp_path), 4)

    def test_vocab_beyond_float32_exact_range_raises(self, tmp_path):
        with pytest.raises(ValueError, match="2\\^24"):
            th.write_raw_ctr_shards(str(tmp_path), 10, 2, 1 << 24, 1)


class TestLibsvmSparsePaths:
    TEXT = "1 3:0.5 7:-2e-1 12:4\n-1 1:1\n0 2:3 5:1 99:2 # comment\n2 4:1.5\n"

    @pytest.mark.parametrize("num_features", [None, 10, 100])
    @pytest.mark.parametrize("multiclass", [False, True])
    def test_csr_matches_jax(self, num_features, multiclass):
        _same(tlibsvm.parse_libsvm_lines(self.TEXT, num_features, dense=False, multiclass=multiclass),
              jlibsvm.parse_libsvm_lines(self.TEXT, num_features, dense=False, multiclass=multiclass))

    @pytest.mark.parametrize("multiclass", [False, True])
    def test_file_paths_match_jax(self, tmp_path, multiclass):
        p = tmp_path / "f"
        p.write_text(self.TEXT)
        _same(tlibsvm.parse_libsvm_file(str(p), 20, multiclass=multiclass),
              jlibsvm.parse_libsvm_file(str(p), 20, multiclass=multiclass))
        _same(tlibsvm.parse_libsvm_file(str(p), 20, dense=False, multiclass=multiclass),
              jlibsvm.parse_libsvm_file(str(p), 20, dense=False, multiclass=multiclass))
