"""The port's scoring tier (``distlr_tpu_torch.serve``) against the JAX
package's (``distlr_tpu.serve``), on the CPU, at small sizes.

The same seeded numpy inputs and weights go to both packages' objects.
Tolerances: ``encode_lines`` exact (bytes and dtypes); dense float32
scores rtol 1e-5; bfloat16 scores 1e-5 absolute with labels equal where
|z| > 1e-3; int8 and int8_dot scores 1e-6 absolute; the sparse and
blocked families 1e-5; softmax scores are the max class probability, at
the tolerance of their product dtype.  ``bucket_hits``, the ``STATS``
keys and types, and the bytes ``pull_chunked`` returns equal the JAX
package's.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.serve import HotReloader as JaxHotReloader
from distlr_tpu.serve import MicroBatcher as JaxMicroBatcher
from distlr_tpu.serve import ScoringEngine as JaxEngine
from distlr_tpu.serve import ScoringServer as JaxServer
from distlr_tpu.serve.batcher import _merge_leaves as jax_merge_leaves
from distlr_tpu_torch import launch
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.models import linear
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.serve import (
    CheckpointWatcher,
    HotReloader,
    LivePSWatcher,
    MicroBatcher,
    ScoringEngine,
    ScoringServer,
    score_lines_over_tcp,
)
from distlr_tpu_torch.serve.batcher import _merge_leaves
from distlr_tpu_torch.obs.registry import MetricsRegistry, percentile_from_counts
from distlr_tpu_torch.train.checkpoint import Checkpointer
from distlr_tpu_torch.train.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(max_batch_size=256, buckets=(64, 256, 1024), idle_evict_s=0.0, **kw):
    """The port's engine (on the CPU) and the JAX package's on one config."""
    ours = ScoringEngine(Config(device="cpu", **kw), max_batch_size=max_batch_size,
                         buckets=buckets, idle_evict_s=idle_evict_s)
    ref = JaxEngine(JaxConfig(**kw), max_batch_size=max_batch_size, buckets=buckets,
                    idle_evict_s=idle_evict_s)
    return ours, ref


def _with_scale(ours, ref, scale):
    """Fold an int8 feature scale into both engines' models."""
    ours.model = dataclasses.replace(ours.model, feature_scale=scale)
    ref.model = dataclasses.replace(ref.model, feature_scale=scale)


def _dense_lines(rng, n, D, *, labeled=True, max_nnz=6):
    """libsvm lines with a few signed features each; every other one
    without a label."""
    lines = []
    for i in range(n):
        k = int(rng.integers(1, max_nnz + 1))
        cols = np.sort(rng.choice(D, size=min(k, D), replace=False))
        feats = " ".join(f"{c + 1}:{v:.4f}" for c, v in zip(cols, rng.standard_normal(len(cols))))
        lines.append(f"{i % 2} {feats}" if labeled and i % 2 == 0 else feats)
    return lines


def _raw_ctr_lines(rng, n, fields, vocab=50):
    raw = rng.integers(0, vocab, size=(n, fields))
    return [" ".join(f"{f + 1}:{v}" for f, v in enumerate(row)) for row in raw]


#: family -> (config, weights shape, request lines) at a small size
def _family_case(family, rng):
    if family == "binary_lr":
        return {"num_feature_dim": 32}, (32,), _dense_lines(rng, 40, 32)
    if family == "softmax":
        return ({"model": "softmax", "num_feature_dim": 24, "num_classes": 3}, (24, 3),
                _dense_lines(rng, 40, 24))
    if family == "sparse_lr":
        return ({"model": "sparse_lr", "num_feature_dim": 500}, (500,),
                _dense_lines(rng, 40, 500, max_nnz=20))
    if family == "sparse_softmax":
        return ({"model": "sparse_softmax", "num_feature_dim": 300, "num_classes": 4},
                (300, 4), _dense_lines(rng, 40, 300, max_nnz=20))
    return ({"model": "blocked_lr", "num_feature_dim": 256, "block_size": 4, "ctr_fields": 5},
            (64, 4), _raw_ctr_lines(rng, 40, 5))


FAMILIES = ("binary_lr", "softmax", "sparse_lr", "sparse_softmax", "blocked_lr")


def _assert_same_leaves(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


class TestScoringEngine:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_encode_lines_matches_jax(self, family):
        kw, _, lines = _family_case(family, np.random.default_rng(1))
        ours, ref = _pair(l2_c=0.0, **kw)
        rows, ref_rows = ours.encode_lines(lines), ref.encode_lines(lines)
        _assert_same_leaves(rows, ref_rows)
        _assert_same_leaves((ours.row_keys(rows),), (ref.row_keys(ref_rows),))
        # one line alone (its own NNZ width for the sparse families)
        _assert_same_leaves(ours.encode_lines(lines[:1]), ref.encode_lines(lines[:1]))

    @pytest.mark.parametrize("fd", ["int8", "int8_dot"])
    def test_int8_encode_lines_matches_jax(self, fd):
        rng = np.random.default_rng(2)
        ours, ref = _pair(num_feature_dim=32, feature_dtype=fd, l2_c=0.0)
        _with_scale(ours, ref, 0.013)
        lines = _dense_lines(rng, 30, 32)
        _assert_same_leaves(ours.encode_lines(lines), ref.encode_lines(lines))

    def test_label_is_optional(self):
        ours, ref = _pair(num_feature_dim=8, l2_c=0.0)
        with_label, without = ours.encode_lines(["1 2:0.5 7:1.0"]), ours.encode_lines(["2:0.5 7:1.0"])
        np.testing.assert_array_equal(with_label[0], without[0])
        _assert_same_leaves(without, ref.encode_lines(["2:0.5 7:1.0"]))

    def test_ragged_nnz_widths_match_jax(self):
        ours, ref = _pair(model="sparse_lr", num_feature_dim=100, l2_c=0.0)
        for lines in (["5:1"], ["1:1 2:1 3:1 4:1 5:1 6:1 7:1 8:1 9:1 10:1"],
                      [" ".join(f"{c}:1" for c in range(1, 40))]):
            got = ours.encode_lines(lines)
            _assert_same_leaves(got, ref.encode_lines(lines))
        assert got[0].shape == (1, 64)

    def test_nnz_width_capped_like_jax(self):
        ours, ref = _pair(model="sparse_lr", num_feature_dim=100, nnz_max=12, l2_c=0.0)
        lines = [" ".join(f"{c}:1" for c in range(1, 40))]
        _assert_same_leaves(ours.encode_lines(lines), ref.encode_lines(lines))

    def test_blocked_request_validation_matches_training(self):
        ours, ref = _pair(model="blocked_lr", num_feature_dim=256, block_size=4,
                          ctr_fields=3, l2_c=0.0)
        for bad, msg in [("0:5 1:7 2:9", "field number"), ("1:5 1:7 3:9", "repeats a field"),
                         ("1:2.7 2:1 3:1", "must be integers"), ("1:5 2:7", "expected 3")]:
            for eng in (ours, ref):
                with pytest.raises(ValueError, match=msg):
                    eng.encode_lines([bad])

    @pytest.mark.parametrize("family", FAMILIES)
    def test_scores_match_jax(self, family):
        """Each family's labels and scores against the JAX engine's on the
        same lines and weights (f32 products for the dense families)."""
        rng = np.random.default_rng(3)
        kw, shape, lines = _family_case(family, rng)
        if family in ("binary_lr", "softmax"):
            kw["compute_dtype"] = "float32"
        ours, ref = _pair(l2_c=0.0, **kw)
        w = rng.standard_normal(shape).astype(np.float32)
        ours.set_weights(w)
        ref.set_weights(w)
        rows = ours.encode_lines(lines)
        labels, scores = ours.score(rows)
        ref_labels, ref_scores = ref.score(ref.encode_lines(lines))
        assert labels.dtype == np.int32 and scores.dtype == np.float32
        assert labels.shape == scores.shape == (len(lines),)
        if family in ("binary_lr", "softmax"):
            np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
        else:
            np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(labels, ref_labels)

    @pytest.mark.parametrize("model", ["binary_lr", "softmax"])
    def test_bf16_scores_match_jax(self, model):
        rng = np.random.default_rng(4)
        kw = {"num_feature_dim": 64}
        shape = (64,)
        if model == "softmax":
            kw.update(model="softmax", num_classes=3)
            shape = (64, 3)
        ours, ref = _pair(l2_c=0.0, **kw)
        w = rng.standard_normal(shape).astype(np.float32)
        ours.set_weights(w)
        ref.set_weights(w)
        X = rng.standard_normal((100, 64)).astype(np.float32)
        labels, scores = ours.score((X,))
        ref_labels, ref_scores = ref.score((X,))
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-5)
        z = X @ w if model == "binary_lr" else np.sort(X @ w, axis=1)
        clear = np.abs(z) > 1e-3 if model == "binary_lr" else (z[:, -1] - z[:, -2]) > 1e-3
        np.testing.assert_array_equal(labels[clear], np.asarray(ref_labels)[clear])

    @pytest.mark.parametrize("fd", ["int8", "int8_dot"])
    def test_int8_scores_match_jax(self, fd):
        rng = np.random.default_rng(5)
        ours, ref = _pair(num_feature_dim=48, feature_dtype=fd, l2_c=0.0)
        _with_scale(ours, ref, 0.02)
        w = (rng.standard_normal(48) * 0.3).astype(np.float32)
        ours.set_weights(w)
        ref.set_weights(w)
        lines = _dense_lines(rng, 70, 48, max_nnz=12)
        rows = ours.encode_lines(lines)
        assert rows[0].dtype == np.int8
        labels, scores = ours.score(rows)
        ref_labels, ref_scores = ref.score(ref.encode_lines(lines))
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(labels, ref_labels)

    def test_bucket_hits_and_chunking_match_jax(self):
        rng = np.random.default_rng(6)
        ours, ref = _pair(num_feature_dim=8, compute_dtype="float32", l2_c=0.0,
                          max_batch_size=64, buckets=(16, 64))
        w = np.ones(8, np.float32)
        ours.set_weights(w)
        ref.set_weights(w)
        for n in (1, 16, 17, 64, 150):
            X = rng.standard_normal((n, 8)).astype(np.float32)
            labels, scores = ours.score((X,))
            np.testing.assert_allclose(scores, ref.score((X,))[1], rtol=1e-5)
            assert labels.shape == (n,)
        assert ours.buckets == ref.buckets == (16, 64)
        assert ours.stats() == ref.stats()
        # 150 rows: chunks of 64, 64 and 22 (padded to 64)
        assert ours.stats()["bucket_hits"] == {16: 2, 64: 5}

    @pytest.mark.parametrize("family", FAMILIES)
    def test_padding_gives_the_bits_of_a_padded_batch(self, family):
        """The engine's zeroed device bucket with the real rows copied in
        scores as the whole np.pad batch does, bit for bit."""
        rng = np.random.default_rng(7)
        kw, shape, lines = _family_case(family, rng)
        eng = ScoringEngine(Config(device="cpu", l2_c=0.0, **kw))
        w = rng.standard_normal(shape).astype(np.float32)
        eng.set_weights(w)
        rows = eng.encode_lines(lines[:5])
        labels, scores = eng.score(rows)
        padded = tuple(torch.from_numpy(np.pad(leaf, [(0, 64 - 5)] + [(0, 0)] * (leaf.ndim - 1)))
                       for leaf in rows)
        if family in ("binary_lr", "softmax"):
            padded = (padded[0].to(eng.product_dtype),)
        z = eng.model.logits(torch.from_numpy(w), *padded)
        p = eng.model.proba_from_logits(z)
        p = p if p.ndim == 1 else p.max(dim=-1).values
        assert torch.equal(torch.from_numpy(scores), p[:5])
        assert torch.equal(torch.from_numpy(labels), eng.model.predict_from_logits(z)[:5])

    def test_one_logits_call_per_bucket_chunk(self, monkeypatch):
        calls = []
        real = linear.lr_logits

        def counting(w, X, **kw):
            calls.append(tuple(X.shape))
            return real(w, X, **kw)

        monkeypatch.setattr(linear, "lr_logits", counting)
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=8, l2_c=0.0),
                            max_batch_size=64, buckets=(16, 64))
        eng.set_weights(np.ones(8, np.float32))
        eng.score((np.ones((150, 8), np.float32),))
        assert calls == [(64, 8), (64, 8), (64, 8)]
        eng.score((np.ones((3, 8), np.float32),))
        assert calls[-1] == (16, 8) and len(calls) == 4

    def test_score_without_weights_raises(self):
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=4))
        with pytest.raises(RuntimeError, match="no weights"):
            eng.score((np.zeros((1, 4), np.float32),))

    def test_atomic_swap_versions(self):
        ours, ref = _pair(num_feature_dim=4, l2_c=0.0)
        assert not ours.has_weights
        versions = [(e.set_weights(np.zeros(4, np.float32)), e.set_weights(np.ones(4, np.float32)))
                    for e in (ours, ref)]
        assert versions[0] == versions[1] == (1, 2)
        np.testing.assert_array_equal(ours.get_weights(), ref.get_weights())
        # the engine holds its own copy: the caller's array and the
        # returned one can change without touching the served weights
        w = np.full(4, 3.0, np.float32)
        ours.set_weights(w)
        w[:] = 0
        ours.get_weights()[:] = 0
        np.testing.assert_array_equal(ours.get_weights(), np.full(4, 3.0))

    def test_swaps_under_concurrent_scoring_are_atomic(self):
        """More scoring threads than cores while another swaps the weights
        back and forth: every result is one table's, bit for bit."""
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=64, l2_c=0.0))
        rng = np.random.default_rng(13)
        ws = [rng.standard_normal(64).astype(np.float32) for _ in range(2)]
        X = rng.standard_normal((20, 64)).astype(np.float32)
        want = []
        for w in ws:
            eng.set_weights(w)
            want.append(eng.score((X,))[1])
        stop, seen, errors = threading.Event(), [], []

        def scorer():
            try:
                while not stop.is_set():
                    seen.append(eng.score((X,))[1])
            except Exception as e:  # surfaced below
                errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        swaps, deadline = 0, time.monotonic() + 30
        try:
            threads = [threading.Thread(target=scorer) for _ in range(2 * (os.cpu_count() or 2))]
            for t in threads:
                t.start()
            # swap until the scorers have scored often enough, whatever their pace
            while (swaps < 200 or len(seen) < 100) and time.monotonic() < deadline:
                eng.set_weights(ws[swaps % 2])
                swaps += 1
            stop.set()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors and len(seen) >= 100
        assert all(np.array_equal(s, want[0]) or np.array_equal(s, want[1]) for s in seen)
        assert eng.weights_version == swaps + 2 and eng.batches_scored == len(seen) + 2

    def test_evict_and_lazy_reload(self):
        ours, ref = _pair(num_feature_dim=8, compute_dtype="float32", l2_c=0.0,
                          idle_evict_s=30.0)
        w = np.linspace(-1, 1, 8).astype(np.float32)
        X = np.random.default_rng(8).standard_normal((5, 8)).astype(np.float32)
        before = {}
        for name, eng in (("ours", ours), ("ref", ref)):
            eng.set_weights(w)
            before[name] = eng.score((X,))
            assert not eng.maybe_evict()  # not idle yet
            assert eng.maybe_evict(now=time.monotonic() + 100)
            assert not eng.resident and eng.has_weights
            # a publish while evicted stays on the host
            assert eng.set_weights(w) == 2 and not eng.resident
        assert ours.stats() == ref.stats()
        assert ours.stats()["evictions"] == 1 and ours.stats()["resident"] is False
        labels, scores = ours.score((X,))
        assert ours.resident
        np.testing.assert_array_equal(scores, before["ours"][1])
        np.testing.assert_array_equal(labels, before["ours"][0])
        ref.score((X,))
        assert set(ours.stats()) == set(ref.stats())

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ScoringEngine(Config(num_feature_dim=4))

    def test_unresolved_auto_block_refused(self):
        with pytest.raises(ValueError, match="auto"):
            ScoringEngine(Config(device="cpu", model="blocked_lr", block_size=0,
                                 num_feature_dim=64))


class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self):
        batch_sizes = []
        done = threading.Event()

        def score(rows):
            done.wait()
            n = rows[0].shape[0]
            batch_sizes.append(n)
            return np.arange(n, dtype=np.int32), rows[0][:, 0].astype(np.float32)

        with MicroBatcher(score, max_batch_size=64, max_wait_ms=20) as mb:
            futs = [mb.submit((np.full((1, 2), float(i), np.float32),)) for i in range(8)]
            done.set()
            results = [f.result(timeout=20) for f in futs]
        for i, (_, scores) in enumerate(results):
            assert scores.shape == (1,) and float(scores[0]) == float(i)
        assert max(batch_sizes) > 1
        stats = mb.stats()
        assert stats["requests"] == 8 and stats["mean_requests_per_batch"] > 1

    def test_flushes_at_max_batch_before_wait(self):
        def score(rows):
            n = rows[0].shape[0]
            return np.zeros(n, np.int32), np.zeros(n, np.float32)

        with MicroBatcher(score, max_batch_size=4, max_wait_ms=60_000) as mb:
            futs = [mb.submit((np.zeros((1, 3), np.float32),)) for _ in range(4)]
            for f in futs:
                f.result(timeout=20)
        assert mb.stats()["batches"] == 1 and mb.stats()["mean_occupancy"] == 1.0

    def test_error_reaches_every_waiter_and_batcher_survives(self):
        hold, calls = threading.Event(), []

        def score(rows):
            hold.wait()
            calls.append(rows[0].shape[0])
            if len(calls) == 1:
                raise ValueError("boom")
            n = rows[0].shape[0]
            return np.zeros(n, np.int32), np.zeros(n, np.float32)

        with MicroBatcher(score, max_batch_size=8, max_wait_ms=20) as mb:
            futs = [mb.submit((np.zeros((1, 2), np.float32),)) for _ in range(3)]
            hold.set()
            for f in futs:
                with pytest.raises(ValueError, match="boom"):
                    f.result(timeout=20)
            assert calls == [3]
            mb.submit((np.zeros((1, 2), np.float32),)).result(timeout=20)

    def test_ragged_merge_matches_jax(self):
        rng = np.random.default_rng(9)
        reqs = [(rng.integers(0, 9, (n, w)).astype(np.int32), rng.random((n, w), np.float32))
                for n, w in ((1, 8), (3, 16), (2, 8))]
        _assert_same_leaves(_merge_leaves(reqs), jax_merge_leaves(reqs))

    def test_ragged_nnz_requests_score_like_jax(self):
        ours, ref = _pair(model="sparse_lr", num_feature_dim=100, l2_c=0.0, max_batch_size=64)
        w = np.arange(100, dtype=np.float32) / 50
        ours.set_weights(w)
        ref.set_weights(w)
        lines = (["5:1"], ["1:1 2:1 3:1 4:1 5:1 6:1 7:1 8:1 9:1 10:1"])
        results = []
        for eng, cls in ((ours, MicroBatcher), (ref, JaxMicroBatcher)):
            hold = threading.Event()

            def gated(rows, eng=eng, hold=hold):
                hold.wait()
                return eng.score(rows)

            with cls(gated, max_batch_size=64, max_wait_ms=20) as mb:
                futs = [mb.submit(eng.encode_lines(ln)) for ln in lines]
                hold.set()
                results.append([f.result(20)[1] for f in futs])
        for a, b in zip(*results):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        assert ours.stats()["bucket_hits"] == ref.stats()["bucket_hits"]


def _trained_weights(D=32, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(D) * 0.5).astype(np.float32)


def _servers(w, **kw):
    """The port's server and the JAX package's on one config and weights."""
    ours, ref = _pair(l2_c=0.0, **kw)
    ours.set_weights(w)
    ref.set_weights(w)
    return ScoringServer(ours, max_wait_ms=1.0), JaxServer(ref, max_wait_ms=1.0)


def _parse_replies(replies):
    labels = np.array([int(r.split()[0]) for r in replies])
    return labels, np.array([float(r.split()[1]) for r in replies])


class TestServerEndToEnd:
    def test_libsvm_and_json_modes_match_jax(self):
        rng = np.random.default_rng(10)
        w = _trained_weights()
        lines = _dense_lines(rng, 60, 32)
        got = []
        ours, ref = _servers(w, num_feature_dim=32, compute_dtype="float32")
        for srv in (ours, ref):
            with srv:
                replies = score_lines_over_tcp(srv.host, srv.port, lines)
                (jrep,) = score_lines_over_tcp(srv.host, srv.port,
                                               [json.dumps({"rows": lines[:25]})])
            got.append((_parse_replies(replies), json.loads(jrep)))
        (ours_l, ours_s), ours_j = got[0]
        (ref_l, ref_s), ref_j = got[1]
        np.testing.assert_array_equal(ours_l, ref_l)
        np.testing.assert_allclose(ours_s, ref_s, rtol=1e-5)
        assert ours_j["labels"] == ref_j["labels"]
        np.testing.assert_allclose(ours_j["scores"], ref_j["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours_j["scores"], ours_s[:25], rtol=1e-5)

    def test_sparse_server_matches_jax(self):
        rng = np.random.default_rng(11)
        w = (rng.standard_normal(2000) * 0.5).astype(np.float32)
        lines = _dense_lines(rng, 40, 2000, max_nnz=9)
        out = []
        for srv in _servers(w, model="sparse_lr", num_feature_dim=2000, max_batch_size=128):
            with srv:
                out.append(_parse_replies(score_lines_over_tcp(srv.host, srv.port, lines)))
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=1e-5)

    def test_err_keeps_the_connection_open(self):
        ours, _ = _servers(_trained_weights(8), num_feature_dim=8)
        with ours as srv:
            bad, bad_json, good = score_lines_over_tcp(
                srv.host, srv.port, ["1:x", '{"rows": []}', "1:1"])
            stats = srv.stats()
        assert bad.startswith("ERR ValueError: ") and bad_json.startswith("ERR ValueError: ")
        assert not good.startswith("ERR")
        assert stats["errors"] == 2 and stats["requests"] == 1

    @pytest.mark.parametrize("line", ["TRACE 00/00 1:1", "TRACE broken",
                                      "TRACE nothex/zz 1:1", "TRACE"])
    def test_trace_lines_answer_like_jax(self, line):
        """A ``TRACE`` prefix joins the request to the caller's trace and
        answers the bare line's reply; a malformed one answers JAX's ERR.
        Both servers reply byte for byte alike, the connection stays up."""
        replies = []
        for srv in _servers(_trained_weights(8), num_feature_dim=8, compute_dtype="float32"):
            with srv:
                replies.append(score_lines_over_tcp(srv.host, srv.port, [line, "1:1"]))
        assert replies[0] == replies[1]
        assert not replies[0][1].startswith("ERR")
        if line == "TRACE 00/00 1:1":
            assert replies[0][0] == replies[0][1]

    # ID / LABEL lines and the JSON "ids" (ROADMAP A.11), on a server without
    # a feedback sink: the id is ignored, LABEL answers the JAX server's ERR
    @pytest.mark.parametrize("line", [
        "ID r1 1:1 2:1", "LABEL r1 1", '{"rows": ["1:1"], "ids": ["r1"]}',
        '{"rows": ["1:1"], "ids": ["r1", "r2"]}', "ID r1",
    ])
    def test_feedback_lines_without_a_sink_answer_like_jax(self, line):
        replies = []
        for srv in _servers(_trained_weights(8), num_feature_dim=8, compute_dtype="float32"):
            with srv:
                replies.append(score_lines_over_tcp(srv.host, srv.port, [line, "1:1"]))
                replies[-1].append(srv.stats()["errors"])
        ours, theirs = replies
        if line.startswith("{") and not ours[0].startswith("ERR"):
            a, b = json.loads(ours[0]), json.loads(theirs[0])
            assert a["labels"] == b["labels"]
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5)
        elif line.startswith("ID r1 "):
            np.testing.assert_allclose(_parse_replies(ours[:2])[1],
                                       _parse_replies(theirs[:2])[1], rtol=1e-5)
        else:
            assert ours[0] == theirs[0] and ours[0].startswith("ERR ValueError: ")
        assert ours[2] == theirs[2]

    # MODEL / @<id> addressing (ROADMAP A.17): answered as the JAX server
    # answers, here on one unnamed engine (an unknown model)
    @pytest.mark.parametrize("line", ["MODEL v2", "@v2 1:1"])
    def test_model_lines_answer_like_jax(self, line):
        replies = []
        for srv in _servers(_trained_weights(8), num_feature_dim=8):
            with srv:
                replies.append(score_lines_over_tcp(srv.host, srv.port, [line, "1:1"]))
                replies[-1].append(srv.stats()["errors"])
        assert replies[0][0] == replies[1][0] == (
            "ERR MODEL: unknown model 'v2' (hosted: default)")
        assert replies[0][2] == replies[1][2] == 1
        _, ours = _parse_replies(replies[0][1:2])
        _, theirs = _parse_replies(replies[1][1:2])
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)

    # the feedback= sink (ROADMAP A.11): accepted, with the JAX server's
    # replies, journal and STATS
    def test_feedback_sink_accepted_like_jax(self, tmp_path):
        from distlr_tpu.feedback import FeedbackSink as JaxSink
        from distlr_tpu_torch.feedback import FeedbackSink

        w = _trained_weights(8)
        lines = ["ID r1 1:1 2:1", "ID r2 3:1", "LABEL r1 1", "LABEL r1 0", "LABEL r9 1",
                 json.dumps({"rows": ["4:1", "5:1"], "ids": ["r3", None]}), "LABEL r3 0"]
        got = []
        for (eng, cls, sink_cls), tag in zip(
                ((e, srv, k) for e, srv, k in zip(_pair(l2_c=0.0, num_feature_dim=8,
                                                        compute_dtype="float32"),
                                                  (ScoringServer, JaxServer),
                                                  (FeedbackSink, JaxSink))), ("ours", "jax")):
            eng.set_weights(w)
            sink = sink_cls(str(tmp_path / tag / "spool"), str(tmp_path / tag / "shards"),
                            window_s=30.0, shard_records=1)
            with cls(eng, max_wait_ms=1.0, feedback=sink) as srv:
                replies = [srv.handle_line(ln) for ln in lines]
                stats = srv.stats()["feedback"]
            got.append((replies, stats, sorted(os.listdir(tmp_path / tag / "shards"))))
        (ours, ours_stats, ours_shards), (theirs, theirs_stats, theirs_shards) = got
        assert ours[2:5] == theirs[2:5] == ["OK joined", "OK duplicate", "OK pending"]
        assert ours[6] == theirs[6] == "OK joined"
        np.testing.assert_allclose(_parse_replies(ours[:2])[1], _parse_replies(theirs[:2])[1],
                                   rtol=1e-5)
        for k in ("join", "drift"):
            assert ours_stats[k] == theirs_stats[k], k
        assert {k: v for k, v in ours_stats["spool"].items()} == theirs_stats["spool"]
        assert ours_shards == theirs_shards == ["shard-000000.libsvm", "shard-000001.libsvm"]
        for name in ours_shards:
            assert (tmp_path / "ours" / "shards" / name).read_bytes() == \
                (tmp_path / "jax" / "shards" / name).read_bytes()

    # several engines (ROADMAP A.17): accepted, with the JAX server's replies
    @pytest.mark.parametrize("kw", [{"engines": ["a"]}])
    def test_server_options_accepted_like_jax(self, kw):
        w = _trained_weights(8)
        replies = []
        for eng in _pair(l2_c=0.0, num_feature_dim=8):
            eng.set_weights(w)
            cls = ScoringServer if isinstance(eng, ScoringEngine) else JaxServer
            with cls(engines={m: eng for m in kw["engines"]}, max_wait_ms=0.5) as srv:
                replies.append(score_lines_over_tcp(srv.host, srv.port,
                                                    ["@a 1:1 2:1", "MODEL a", "3:1"]))
                replies[-1].append(srv.stats()["models"])
        assert replies[0][1] == replies[1][1] == "OK MODEL a"
        assert replies[0][3] == replies[1][3] == 1
        for i in (0, 2):
            np.testing.assert_allclose(_parse_replies([replies[0][i]])[1],
                                       _parse_replies([replies[1][i]])[1], rtol=1e-5)

    @pytest.mark.parametrize("lines,keys", [
        (["1:1 3:1", "3:1 8:1"], {0: 1, 2: 2, 7: 1}),
        (['{"rows": ["2:1", "2:1 5:1"]}'], {1: 1, 4: 1}),
    ])
    def test_hot_tracker_observes_request_row_keys(self, lines, keys):
        """A server given a ``hot_tracker`` feeds it the row keys of every
        request (``engine.row_keys``: the columns any row of a batch uses),
        as the JAX server does."""
        from distlr_tpu.serve import HotSetTracker as JaxHotSetTracker
        from distlr_tpu_torch.serve import HotSetTracker

        ours, theirs = HotSetTracker(16), JaxHotSetTracker(16)
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=8))
        eng.set_weights(_trained_weights(8))
        jeng = JaxEngine(JaxConfig(num_feature_dim=8))
        jeng.set_weights(_trained_weights(8))
        with ScoringServer(eng, hot_tracker=ours) as srv, \
                JaxServer(jeng, hot_tracker=theirs) as jsrv:
            replies = score_lines_over_tcp(srv.host, srv.port, lines)
            jreplies = score_lines_over_tcp(jsrv.host, jsrv.port, lines)
        assert not any(r.startswith("ERR") for r in replies + jreplies)
        assert dict(ours._counts) == dict(theirs._counts) == keys
        np.testing.assert_array_equal(ours.hot_keys(), theirs.hot_keys())

    def test_abort_severs_open_connections(self):
        ours, _ = _servers(_trained_weights(8), num_feature_dim=8)
        ours.start()
        with socket.create_connection((ours.host, ours.port), timeout=10) as s:
            f = s.makefile("rwb")
            f.write(b"1:1\n")
            f.flush()
            assert f.readline()
            ours.abort()
            f.write(b"1:1\n")
            try:
                f.flush()
                assert f.readline() == b""
            except OSError:
                pass  # a reset is as good as an EOF here
        assert ours.metrics.closed


class _StreamingClient:
    """Streams one probe line in a loop in the background and keeps every
    reply (the witness of requests in flight across weight swaps)."""

    def __init__(self, host, port, line):
        self.replies: list[str] = []
        self.errors: list[BaseException] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(host, port, line), daemon=True)
        self._t.start()

    def _run(self, host, port, line):
        try:
            with socket.create_connection((host, port), timeout=30) as s:
                f = s.makefile("rwb")
                while not self._stop.is_set():
                    f.write((line + "\n").encode())
                    f.flush()
                    reply = f.readline()
                    if not reply:
                        raise ConnectionError("server closed mid-stream")
                    self.replies.append(reply.decode().strip())
        except BaseException as e:
            self.errors.append(e)

    def wait_for(self, n, timeout=30):
        t0 = time.monotonic()
        while len(self.replies) < n and time.monotonic() - t0 < timeout:
            time.sleep(0.01)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=30)


class TestHotReload:
    def test_checkpoint_watch_swaps_mid_stream(self, tmp_path):
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=8, l2_c=0.0))
        ck_dir = str(tmp_path / "ck")
        reloader = HotReloader(eng, CheckpointWatcher(ck_dir), interval_s=0.05).start()
        with Checkpointer(ck_dir) as ck:
            ck.save(1, np.full(8, 1.0, np.float32), extra={"epoch": 1})
            reloader.wait_for_weights(30)
            with ScoringServer(eng, max_wait_ms=1.0, reloader=reloader) as srv:
                client = _StreamingClient(srv.host, srv.port, "1:1 2:1")
                client.wait_for(1)
                ck.save(2, np.full(8, -1.0, np.float32), extra={"epoch": 2})
                t0 = time.monotonic()
                while reloader.last_version != 2 and time.monotonic() - t0 < 30:
                    time.sleep(0.01)
                assert reloader.last_version == 2
                client.wait_for(len(client.replies) + 5)
                client.stop()
                stats = srv.stats()
        assert not client.errors, client.errors
        assert not any(r.startswith("ERR") for r in client.replies)
        labels = [int(r.split()[0]) for r in client.replies]
        assert labels[0] == 1 and labels[-1] == 0
        assert sum(a != b for a, b in zip(labels, labels[1:])) == 1, labels
        assert stats["reload"]["reloads"] == 2 and stats["engine"]["weights_version"] == 2

    def test_live_ps_reload_while_async_trainer_pushes(self, tmp_path):
        from distlr_tpu_torch.train.ps_trainer import ps_param_dim, run_ps_workers

        d = str(tmp_path / "psdata")
        write_synthetic_shards(d, 2000, 128, num_parts=1, seed=5, sparsity=0.0)
        cfg = Config(data_dir=d, num_feature_dim=128, sync_mode=False, num_workers=1,
                     num_servers=1, num_iteration=400, learning_rate=0.05, l2_c=0.0,
                     test_interval=0, ps_timeout_ms=30_000, device="cpu")
        with ServerGroup(1, 1, ps_param_dim(cfg), learning_rate=cfg.learning_rate,
                         sync=False) as sg:
            train_errs = []

            def train():
                try:
                    run_ps_workers(cfg, sg.hosts, [0])
                except BaseException as e:
                    train_errs.append(e)

            trainer = threading.Thread(target=train, daemon=True)
            trainer.start()
            eng = ScoringEngine(cfg)
            watcher = LivePSWatcher(sg.hosts, ps_param_dim(cfg))
            reloader = HotReloader(eng, watcher, interval_s=0.01).start()
            reloader.wait_for_weights(30)
            with ScoringServer(eng, max_wait_ms=0.5, reloader=reloader) as srv:
                client = _StreamingClient(srv.host, srv.port, "1:1 5:1 9:1 100:1")
                trainer.join(timeout=120)
                assert not trainer.is_alive()
                time.sleep(0.1)
                client.stop()
                stats = srv.stats()
        assert not train_errs, train_errs
        assert not client.errors, client.errors
        assert client.replies and not any(r.startswith("ERR") for r in client.replies)
        assert reloader.reloads >= 2
        assert len({r.split()[1] for r in client.replies}) >= 2
        assert stats["reload"]["source"]["full_reloads"] == reloader.reloads
        assert stats["reload"]["source"]["last_rows"] == 128

    def test_pull_chunked_returns_the_jax_clients_bytes(self):
        from distlr_tpu.ps import KVWorker as JaxKVWorker

        with ServerGroup(3, 1, dim=50, sync=False) as sg, KVWorker(sg.hosts, 50) as kv, \
                JaxKVWorker(sg.hosts, 50, client_id=1) as jkv:
            init = np.linspace(-2, 2, 50).astype(np.float32)
            kv.push_init(init)
            for chunk in (7, 100):
                got = kv.pull_chunked(chunk_rows=chunk)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, jkv.pull_chunked(chunk_rows=chunk))
                np.testing.assert_array_equal(got, init)
            sub = np.array([3, 17, 44], np.uint64)
            np.testing.assert_array_equal(kv.pull_chunked(sub, chunk_rows=2),
                                          jkv.pull_chunked(sub, chunk_rows=2))
            empty = kv.pull_chunked(np.array([], np.uint64), chunk_rows=4)
            assert empty.shape == (0,) and empty.dtype == np.float32
            with pytest.raises(ValueError, match="chunk_rows"):
                kv.pull_chunked(chunk_rows=0)
            # rows of 2 straddle the boundary 33 (dim 50 over 3 servers): both refuse
            for client in (kv, jkv):
                with pytest.raises(ValueError, match="straddle"):
                    client.pull_chunked(vals_per_key=2)

    def test_live_watcher_waits_for_init_and_reconnects(self):
        with ServerGroup(2, 1, dim=16, sync=False) as sg:
            watcher = LivePSWatcher(sg.hosts, 16, chunk_rows=5)
            eng = ScoringEngine(Config(device="cpu", num_feature_dim=16))
            reloader = HotReloader(eng, watcher, interval_s=0.05)
            assert watcher.poll() is None  # the group is not seeded yet
            assert "UNINITIALIZED" in watcher.describe_unready()
            with pytest.raises(TimeoutError, match="UNINITIALIZED"):
                reloader.wait_for_weights(0.3)
            with KVWorker(sg.hosts, 16) as kv:
                kv.push_init(np.arange(16, dtype=np.float32))
            reloader.wait_for_weights(10)
            np.testing.assert_array_equal(eng.get_weights(), np.arange(16))
            real = watcher.kv.pull_chunked
            watcher.kv.pull_chunked = lambda **kw: (_ for _ in ()).throw(OSError("blip"))
            assert not reloader._poll_once() and reloader.errors == 1
            np.testing.assert_array_equal(eng.get_weights(), np.arange(16))  # last good
            watcher.kv.pull_chunked = real
            old = watcher.kv._h
            assert reloader._poll_once()
            assert watcher.kv._h != old  # it reconnected, then re-checked init
            assert reloader.stats()["last_version"] == 2
            reloader.stop()
        assert "unreachable" in watcher.describe_unready()

    @pytest.mark.parametrize("package", ["both"])
    def test_watcher_route_follows_a_resize_like_jax(self, package):
        """``LivePSWatcher(None, route=)``: each package's watcher on its
        own group and coordinator polls the same weights before and after
        a 2 -> 4 resize, its client re-routed once."""
        from distlr_tpu.ps import KVWorker as JaxKVWorker
        from distlr_tpu.ps import MembershipCoordinator as JaxCoordinator
        from distlr_tpu.ps import ServerGroup as JaxServerGroup
        from distlr_tpu.serve import LivePSWatcher as JaxWatcher

        from distlr_tpu_torch.ps import MembershipCoordinator

        w = np.linspace(-1, 1, 16).astype(np.float32)
        got = {}
        for tag, group_cls, coord_cls, kv_cls, watcher_cls in (
                ("ours", ServerGroup, MembershipCoordinator, KVWorker, LivePSWatcher),
                ("jax", JaxServerGroup, JaxCoordinator, JaxKVWorker, JaxWatcher)):
            with group_cls(2, 1, dim=16, sync=False) as sg:
                coord = coord_cls(sg)
                with kv_cls(sg.hosts, 16) as kv:
                    kv.push_init(w)
                watcher = watcher_cls(None, 16, route=coord.layout)
                first = watcher.poll()
                coord.resize(4)
                second = watcher.poll()
                got[tag] = (first[0], second[0], watcher.kv.num_servers)
                np.testing.assert_array_equal(first[1], w)
                np.testing.assert_array_equal(second[1], w)
                watcher.close()
        assert got["ours"] == got["jax"] == (1, 2, 4)

    def test_watcher_retry_rides_a_server_respawn(self):
        """``LivePSWatcher(retry=)`` as in the JAX package: its client
        carries the policy, and a poll after a server's SIGKILL and
        respawn succeeds within the poll (a retry, no failed poll).
        ``launch serve`` builds the policy as JAX's does."""
        from distlr_tpu.ps import RetryPolicy as JaxRetryPolicy

        from distlr_tpu_torch.ps import RetryPolicy

        cfg = Config(device="cpu", ps_retry_attempts=6, ps_retry_backoff_ms=20.0)
        pol = RetryPolicy.from_config(cfg)
        assert dataclasses.asdict(pol) == dataclasses.asdict(JaxRetryPolicy.from_config(
            JaxConfig(ps_retry_attempts=6, ps_retry_backoff_ms=20.0)))
        init = np.linspace(-1, 1, 16).astype(np.float32)
        with ServerGroup(2, 1, dim=16, sync=False) as sg:
            with KVWorker(sg.hosts, 16) as kv:
                kv.push_init(init)
            watcher = LivePSWatcher(sg.hosts, 16, retry=pol)
            assert watcher.kv.retry is pol
            assert watcher.poll()[0] == 1
            sg.procs[1].kill()
            sg.procs[1].wait()
            assert sg.respawn(1)
            with KVWorker(f"127.0.0.1:{sg.ports[1]}", 8) as kv1:
                kv1.push_init(init[8:])
            version, w = watcher.poll()
            watcher.close()
        assert version == 2
        np.testing.assert_array_equal(w, init)
        assert sum(watcher.kv.retries.values()) >= 1

    @pytest.mark.parametrize("kw,mode,rows", [
        ({"vals_per_key": 4}, "full", 4), ({"hot_tracker": "tracker"}, "hot", 16),
    ])
    def test_watcher_rows_and_hot_tracker(self, kw, mode, rows):
        """``vals_per_key`` rows (2 servers at dim 16: the boundary 8 is a
        multiple of 4) and a hot tracker: the first poll is a full pull of
        the seeded table, and ``stats()`` reports the mode."""
        from distlr_tpu_torch.serve import HotSetTracker

        if kw.get("hot_tracker") == "tracker":
            kw = {"hot_tracker": HotSetTracker(4)}
        init = np.linspace(-1, 1, 16).astype(np.float32)
        with ServerGroup(2, 1, dim=16, sync=False) as sg:
            with KVWorker(sg.hosts, 16) as kv:
                kv.push_init(init)
            watcher = LivePSWatcher(sg.hosts, 16, chunk_rows=3, **kw)
            version, w = watcher.poll()
            watcher.close()
        assert version == 1
        np.testing.assert_array_equal(w, init)
        st = watcher.stats()
        assert (st["mode"], st["full_reloads"], st["last_kind"], st["last_rows"]) == (
            mode, 1, "full", rows)

    def test_reloader_stats_and_errors_match_jax(self):
        class Flaky:
            def __init__(self):
                self.n = 0

            def poll(self):
                self.n += 1
                if self.n == 2:
                    raise OSError("down")
                return self.n, np.full(4, float(self.n), np.float32)

            def close(self):
                pass

        stats = []
        for eng, cls in ((ScoringEngine(Config(device="cpu", num_feature_dim=4)), HotReloader),
                         (JaxEngine(JaxConfig(num_feature_dim=4)), JaxHotReloader)):
            rl = cls(eng, Flaky(), interval_s=0.5, jitter=0.0)
            rl.wait_for_weights(5)
            assert not rl._poll_once()
            np.testing.assert_array_equal(eng.get_weights(), np.ones(4))  # last good
            assert rl._poll_once()
            stats.append(rl.stats())
            rl.stop()
        assert stats[0] == stats[1]
        assert stats[0]["reload_errors"] == 1 and stats[0]["last_version"] == 3

    def test_reloader_jitter_and_checks(self):
        rl = HotReloader(None, None, interval_s=1.0, jitter=0.2, _seed=3)
        waits = [rl._next_wait() for _ in range(200)]
        assert 0.8 <= min(waits) < max(waits) <= 1.2
        assert HotReloader(None, None, interval_s=1.0, jitter=0.0)._next_wait() == 1.0
        for kw in ({"interval_s": 0}, {"jitter": 1.0}):
            with pytest.raises(ValueError):
                HotReloader(None, None, **kw)


def _stats_shape(doc):
    """The key structure and value types of a STATS reply (ints and floats
    alike count as numbers, as the JAX schema test reads them)."""
    if isinstance(doc, dict):
        return {k: _stats_shape(v) for k, v in doc.items()}
    if isinstance(doc, bool) or doc is None:
        return type(doc).__name__
    if isinstance(doc, (int, float)):
        return "int" if isinstance(doc, int) else "number"
    return type(doc).__name__


class TestStatsSchemaRegression:
    def _server(self, cls_pair=False):
        ours, ref = _pair(num_feature_dim=8, l2_c=0.0, max_batch_size=64)
        w = np.linspace(-1, 1, 8).astype(np.float32)
        ours.set_weights(w)
        ref.set_weights(w)
        if cls_pair:
            return ScoringServer(ours, max_wait_ms=0.5), JaxServer(ref, max_wait_ms=0.5)
        return ScoringServer(ours, max_wait_ms=0.5)

    def test_stats_keys_and_types_equal_jax(self):
        docs = []
        for srv in self._server(cls_pair=True):
            with srv:
                for _ in range(5):
                    score_lines_over_tcp(srv.host, srv.port, ["1:1 3:1"])
                score_lines_over_tcp(srv.host, srv.port, ['{"rows": []}'])
                (raw,) = score_lines_over_tcp(srv.host, srv.port, ["STATS"])
            docs.append(json.loads(raw))
        ours, ref = docs
        assert _stats_shape(ours) == _stats_shape(ref)
        assert set(ours) == {"requests", "errors", "qps", "p50_ms", "p99_ms", "shed",
                             "retries", "replica_count", "models", "per_model", "batcher",
                             "engine"}
        for k in ("requests", "errors", "shed", "retries", "replica_count", "models"):
            assert ours[k] == ref[k], k
        assert ours["engine"] == ref["engine"]
        assert round(ours["qps"], 2) == ours["qps"] and round(ours["p50_ms"], 3) == ours["p50_ms"]
        assert ours["p50_ms"] <= ours["p99_ms"]

    def test_stats_with_a_reloader_equal_jax(self, tmp_path):
        from distlr_tpu.serve import CheckpointWatcher as JaxCheckpointWatcher
        from distlr_tpu.train.checkpoint import Checkpointer as JaxCheckpointer

        w = np.linspace(-1, 1, 8).astype(np.float32)
        Checkpointer(str(tmp_path / "ours")).save(1, w)
        with JaxCheckpointer(str(tmp_path / "ref")) as ck:
            ck.save(1, w, extra={"epoch": 1})
        docs = []
        for eng, rl_cls, watch, srv_cls, d in (
                (ScoringEngine(Config(device="cpu", num_feature_dim=8)), HotReloader,
                 CheckpointWatcher, ScoringServer, "ours"),
                (JaxEngine(JaxConfig(num_feature_dim=8)), JaxHotReloader,
                 JaxCheckpointWatcher, JaxServer, "ref")):
            rl = rl_cls(eng, watch(str(tmp_path / d)), interval_s=5.0)
            rl.wait_for_weights(10)
            with srv_cls(eng, max_wait_ms=0.5, reloader=rl) as srv:
                score_lines_over_tcp(srv.host, srv.port, ["1:1"])
                docs.append(srv.stats())
        assert _stats_shape(docs[0]) == _stats_shape(docs[1])
        assert docs[0]["reload"] == docs[1]["reload"]

    def test_percentiles_track_real_latency_scale(self):
        with self._server() as srv:
            for _ in range(20):
                score_lines_over_tcp(srv.host, srv.port, ["1:1"])
            stats = json.loads(score_lines_over_tcp(srv.host, srv.port, ["STATS"])[0])
        assert 0.0 < stats["p50_ms"] <= stats["p99_ms"] < 10_000.0

    def test_percentiles_equal_the_jax_registrys(self):
        """STATS percentiles come from the port's registry histogram (the
        request series' default buckets): the JAX registry's estimate."""
        from distlr_tpu.obs.registry import DEFAULT_BUCKETS
        from distlr_tpu.obs.registry import percentile_from_counts as jax_percentile

        from distlr_tpu_torch.obs.registry import DEFAULT_BUCKETS as LATENCY_BUCKETS

        assert LATENCY_BUCKETS == DEFAULT_BUCKETS
        rng = np.random.default_rng(12)
        hist = MetricsRegistry().histogram("distlr_serve_request_seconds", "x")
        samples = rng.lognormal(-6, 1.5, 500)
        for v in samples:
            hist.observe(float(v))
        counts = np.bincount(np.searchsorted(DEFAULT_BUCKETS, samples, side="left"),
                             minlength=len(DEFAULT_BUCKETS) + 1)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert hist.percentile(q) == jax_percentile(DEFAULT_BUCKETS, counts.tolist(), q)
            assert percentile_from_counts(DEFAULT_BUCKETS, counts.tolist(), q) == hist.percentile(q)
        assert MetricsRegistry().histogram("h", "x").percentile(0.5) == 0.0

    def test_stats_readable_after_stop(self):
        with self._server() as srv:
            score_lines_over_tcp(srv.host, srv.port, ["1:1", "2:1"])
        post = srv.stats()
        assert post["requests"] == 2 and post["errors"] == 0 and post["p50_ms"] >= 0
        assert srv.metrics.closed

    def test_stats_mirror_into_the_metrics_records(self):
        with self._server() as srv:
            score_lines_over_tcp(srv.host, srv.port, ["1:1", "STATS"])
            assert srv.metrics.latest("requests") == 1
            assert srv.metrics.latest("occupancy") is not None

    def test_per_server_isolation(self):
        with self._server() as a:
            score_lines_over_tcp(a.host, a.port, ["1:1", "2:1", "3:1"])
            with self._server() as b:
                score_lines_over_tcp(b.host, b.port, ["1:1"])
                sb = json.loads(score_lines_over_tcp(b.host, b.port, ["STATS"])[0])
            sa = json.loads(score_lines_over_tcp(a.host, a.port, ["STATS"])[0])
        assert sb["requests"] == 1 and sa["requests"] == 3


def test_metrics_logger_closed_property(tmp_path):
    m = MetricsLogger(str(tmp_path / "m.jsonl"))
    assert not m.closed
    m.log(x=1)
    m.close()
    assert m.closed
    with pytest.raises(RuntimeError, match="closed"):
        m.log(x=2)


def _launch_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


class TestLaunchServe:
    @pytest.fixture(scope="class")
    def model_dir(self, tmp_path_factory):
        from distlr_tpu_torch.train import Trainer

        d = str(tmp_path_factory.mktemp("serve") / "d")
        write_synthetic_shards(d, 600, 24, num_parts=1, seed=3)
        tr = Trainer(Config(data_dir=d, num_feature_dim=24, num_iteration=5, l2_c=0.0,
                            test_interval=0, learning_rate=0.5, device="cpu")).load_data()
        tr.fit()
        return d, tr.save_model()

    def test_serve_on_cpu_answers_then_exits_143_on_sigterm(self, model_dir):
        d, model_file = model_dir
        proc = subprocess.Popen(
            [sys.executable, "-m", "distlr_tpu_torch.launch", "serve", "--num-feature-dim", "24",
             "--model-file", model_file, "--port", "0", "--device", "cpu"],
            cwd=REPO, env=_launch_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            line = proc.stdout.readline()
            assert line.startswith("SERVING "), (line, proc.stderr.read() if proc.poll() else "")
            host, port = line.split()[1].rsplit(":", 1)
            with open(os.path.join(d, "test", "part-001")) as f:
                lines = [ln.strip() for ln in f if ln.strip()][:3]
            replies = score_lines_over_tcp(host, int(port), lines)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 143
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        from distlr_tpu_torch.train.export import load_model_text

        eng = ScoringEngine(Config(num_feature_dim=24, device="cpu"))
        eng.set_weights(load_model_text(model_file))
        labels, scores = eng.score(eng.encode_lines(lines))
        got_l, got_s = _parse_replies(replies)
        np.testing.assert_array_equal(got_l, labels)
        np.testing.assert_allclose(got_s, scores, rtol=1e-5)

    def test_checkpoint_dir_source_in_process(self, model_dir, tmp_path, monkeypatch):
        """``cmd_serve`` with a watched checkpoint dir: the reloader's first
        poll publishes before the server listens."""
        ck = str(tmp_path / "ck")
        w = np.linspace(-1, 1, 24).astype(np.float32)
        Checkpointer(ck).save(3, w)
        seen = {}

        def fake_forever(self):
            seen["stats"] = self.stats()
            seen["weights"] = self.engine.get_weights()
            self.stop()

        monkeypatch.setattr(ScoringServer, "serve_forever", fake_forever)
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        assert launch.main(["serve", "--num-feature-dim", "24", "--checkpoint-dir", ck,
                            "--device", "cpu", "--reload-interval", "5"]) == 0
        assert seen["stats"]["reload"]["last_version"] == 3
        np.testing.assert_array_equal(seen["weights"], w)

    def test_model_file_takes_a_checkpoint_dir(self, tmp_path, monkeypatch):
        """``--model-file <checkpoint dir>`` serves the latest step's weights
        (JAX: ``load_weights``), with no watcher."""
        ck = str(tmp_path / "ck")
        old, new = np.zeros(24, np.float32), np.linspace(-1, 1, 24).astype(np.float32)
        with Checkpointer(ck) as c:
            c.save(2, old)
            c.save(5, new)
        seen = {}

        def fake_forever(self):
            seen["weights"] = self.engine.get_weights()
            seen["reloader"] = self.reloader
            self.stop()

        monkeypatch.setattr(ScoringServer, "serve_forever", fake_forever)
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        assert launch.main(["serve", "--num-feature-dim", "24", "--model-file", ck,
                            "--device", "cpu"]) == 0
        np.testing.assert_array_equal(seen["weights"], new)
        assert seen["reloader"] is None

    def test_model_file_empty_checkpoint_dir_raises_like_jax(self, tmp_path):
        from distlr_tpu.train.export import load_weights as jax_load_weights
        from distlr_tpu_torch.train import load_weights

        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(FileNotFoundError, match="no checkpoint steps") as theirs:
            jax_load_weights(str(empty))
        with pytest.raises(FileNotFoundError, match="no checkpoint steps") as ours:
            launch.main(["serve", "--num-feature-dim", "24", "--model-file", str(empty),
                         "--device", "cpu"])
        assert str(ours.value) == str(theirs.value)
        with pytest.raises(FileNotFoundError):
            load_weights(str(empty), shape=(24,))

    def test_load_weights_reads_text_models_and_shapes(self, tmp_path):
        from distlr_tpu_torch.train import load_weights, save_model_text

        w = np.arange(12, dtype=np.float32)
        save_model_text(str(tmp_path / "m.txt"), w)
        np.testing.assert_array_equal(load_weights(str(tmp_path / "m.txt"), shape=(4, 3)),
                                      w.reshape(4, 3))
        Checkpointer(str(tmp_path / "ck")).save(1, w.reshape(4, 3))
        np.testing.assert_array_equal(load_weights(str(tmp_path / "ck")), w)

    def test_serve_needs_a_weight_source(self, capsys):
        assert launch.main(["serve", "--num-feature-dim", "8", "--device", "cpu"]) == 2
        assert "needs a weight source" in capsys.readouterr().err

    def test_blocked_auto_needs_a_data_dir(self, model_dir, capsys, tmp_path):
        _, model_file = model_dir
        assert launch.main(["serve", "--model", "blocked_lr", "--block-size", "auto",
                            "--num-feature-dim", "64", "--data-dir", str(tmp_path / "none"),
                            "--model-file", model_file, "--device", "cpu"]) == 2
        assert "blocked_lr serving needs" in capsys.readouterr().err

    def test_serve_without_cuda_raises(self, model_dir, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch.main(["serve", "--num-feature-dim", "24", "--model-file", model_dir[1]])

    @pytest.mark.parametrize("argv", [["--ps-ctl"]])
    def test_serve_ps_ctl_follows_a_live_resize(self, argv, monkeypatch):
        """``launch serve --ps-ctl`` without ``--ps-hosts``, as the JAX
        package's: the watcher routes by the coordinator's layout, and a
        served score after a resize is the resized group's."""
        from distlr_tpu_torch.ps import MembershipCoordinator, MembershipServer

        rng = np.random.default_rng(21)
        D = 24
        w1, w2 = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
        lines = _dense_lines(rng, 4, D)
        seen = {}
        with ServerGroup(2, 1, dim=D, sync=False) as sg, \
                MembershipServer(MembershipCoordinator(sg)) as ctl:
            with KVWorker(sg.hosts, D) as kv:
                kv.push_init(w1)

            def fake_forever(self):
                seen["before"] = [self.handle_line(ln) for ln in lines]
                assert ctl.coordinator.resize(4)["ok"]
                with KVWorker(None, D, route=ctl.coordinator.layout) as kv:
                    kv.push_init(w2, force=True)
                assert self.reloader._poll_once()
                seen["after"] = [self.handle_line(ln) for ln in lines]
                seen["source"] = self.reloader.source
                self.stop()

            monkeypatch.setattr(ScoringServer, "serve_forever", fake_forever)
            monkeypatch.setattr(signal, "signal", lambda *a: None)
            assert launch.main(["serve", "--num-feature-dim", str(D), *argv,
                                f"127.0.0.1:{ctl.port}", "--device", "cpu",
                                "--reload-interval", "30"]) == 0
            assert seen["source"].hosts == sg.hosts and sg.num_servers == 4
            assert seen["source"].kv.reroutes == 1
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=D))
        for w, key in ((w1, "before"), (w2, "after")):
            eng.set_weights(w)
            labels, scores = eng.score(eng.encode_lines(lines))
            got_l, got_s = _parse_replies(seen[key])
            np.testing.assert_array_equal(got_l, labels)
            np.testing.assert_allclose(got_s, scores, rtol=1e-5)

    # the feedback loop's flags (ROADMAP A.11): the same Config as the JAX
    # package's launch serve builds, taken where each builds its engine
    @pytest.mark.parametrize("argv,field", [
        (["--feedback-spool", "spool"], "feedback_spool_dir"),
        (["--feedback-shards", "shards"], "feedback_shard_dir"),
        (["--feedback-window", "5"], "feedback_window_s"),
        (["--feedback-negative-rate", "0.3"], "feedback_negative_rate"),
        (["--feedback-shard-records", "64"], "feedback_shard_records"),
        (["--feedback-capacity", "10"], "feedback_capacity"),
        (["--drift-block", "32"], "feedback_drift_block"),
        (["--drift-threshold", "0.5"], "feedback_drift_threshold"),
    ])
    def test_feedback_serve_flags_reach_config_like_jax(self, argv, field, model_dir,
                                                        monkeypatch):
        import distlr_tpu.serve as jax_serve
        import distlr_tpu_torch.serve as serve
        from distlr_tpu import launch as jax_launch

        seen = {}

        class _Seen(Exception):
            pass

        def grab(key):
            def f(cfg, *a, **k):
                seen[key] = cfg
                raise _Seen
            return f

        monkeypatch.setattr(serve, "ScoringEngine", grab("ours"))
        monkeypatch.setattr(jax_serve, "ScoringEngine", grab("jax"))
        common = ["serve", "--num-feature-dim", "24", "--model-file", model_dir[1], *argv]
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            with pytest.raises(_Seen):
                main(common + extra)
        assert getattr(seen["ours"], field) == getattr(seen["jax"], field) != getattr(
            Config(), field)


class TestLaunchServeLivePS:
    """``launch serve --ps-hosts`` in process (``serve_forever`` replaced by
    a probe): keyed rows and the hot-row flags."""

    @staticmethod
    def _serve(monkeypatch, argv, hosts, lines):
        seen = {}

        def fake_forever(self):
            # with a tracker: the start-up poll publishes an empty hot set, so
            # the next poll is a full one (coverage 0) and the one after hot
            seen["replies"] = [[self.handle_line(ln) for ln in lines]]
            for _ in range(2):
                assert self.reloader._poll_once()
                seen["replies"].append([self.handle_line(ln) for ln in lines])
            seen["stats"] = self.stats()
            seen["source"] = self.reloader.source
            seen["hot_tracker"] = self.hot_tracker
            self.stop()

        monkeypatch.setattr(ScoringServer, "serve_forever", fake_forever)
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        assert launch.main(["serve", "--ps-hosts", hosts, "--device", "cpu",
                            "--reload-interval", "30", *argv]) == 0
        return seen

    @pytest.mark.parametrize("argv,mode", [
        (["--model", "blocked_lr", "--block-size", "8", "--ctr-fields", "8"], "full"),
        (["--hot-rows", "64"], "hot"),
        (["--hot-rows", "64", "--hot-min-coverage", "0.5"], "hot"),
        (["--hot-rows", "64", "--hot-full-every", "0"], "hot"),
    ])
    def test_live_ps_serving_flags_run(self, monkeypatch, argv, mode):
        rng = np.random.default_rng(5)
        blocked = "blocked_lr" in argv
        D = 64
        w = rng.standard_normal(D).astype(np.float32)
        lines = (_raw_ctr_lines(rng, 3, 8) if blocked
                 else [ln for ln in _dense_lines(rng, 3, D)])
        with ServerGroup(2, 1, dim=D, sync=False) as sg:
            with KVWorker(sg.hosts, D) as kv:
                kv.push_init(w)
            seen = self._serve(monkeypatch, ["--num-feature-dim", str(D), *argv], sg.hosts,
                               lines)
        src = seen["source"]
        assert src.row_width == src.vals_per_key == (8 if blocked else 1)
        assert seen["stats"]["reload"]["source"]["mode"] == mode
        assert (seen["hot_tracker"] is None) == (mode == "full")
        if mode == "hot":
            assert src.hot_tracker is seen["hot_tracker"]
            assert (seen["stats"]["reload"]["source"]["full_reloads"],
                    seen["stats"]["reload"]["source"]["hot_reloads"]) == (2, 1)
            assert (src.min_coverage, src.full_refresh_every) == (
                float(argv[argv.index("--hot-min-coverage") + 1])
                if "--hot-min-coverage" in argv else 0.95,
                int(argv[argv.index("--hot-full-every") + 1])
                if "--hot-full-every" in argv else 10)
        # the served scores are the engine's on the group's table
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=D,
                                   **({"model": "blocked_lr", "block_size": 8, "ctr_fields": 8}
                                      if blocked else {})))
        eng.set_weights(w)
        labels, scores = eng.score(eng.encode_lines(lines))
        for replies in seen["replies"]:
            got_l, got_s = _parse_replies(replies)
            np.testing.assert_array_equal(got_l, labels)
            np.testing.assert_allclose(got_s, scores, rtol=1e-5)

    def test_hot_rows_need_a_live_ps(self, capsys):
        assert launch.main(["serve", "--num-feature-dim", "8", "--device", "cpu",
                            "--model-file", "m", "--hot-rows", "4"]) == 2
        assert "--hot-rows applies to live-PS reload only" in capsys.readouterr().err

    def test_dense_softmax_pulls_class_rows_and_serves_the_same_scores(self, monkeypatch):
        """Dense softmax's live pull takes ``num_classes`` values a key, as
        the JAX package's (its flat ``(D, K)`` keys are the same slots):
        the served scores equal those of the flat-key pull."""
        rng = np.random.default_rng(8)
        D, K = 24, 3
        w = rng.standard_normal(D * K).astype(np.float32)
        lines = _dense_lines(rng, 5, D)
        with ServerGroup(2, 1, dim=D * K, sync=False) as sg:
            with KVWorker(sg.hosts, D * K) as kv:
                kv.push_init(w)
            flat = LivePSWatcher(sg.hosts, D * K)
            _, w_flat = flat.poll()
            flat.close()
            seen = self._serve(monkeypatch, ["--model", "softmax", "--num-classes", str(K),
                                             "--num-feature-dim", str(D)], sg.hosts, lines)
        assert seen["source"].vals_per_key == K
        np.testing.assert_array_equal(w_flat, w)
        eng = ScoringEngine(Config(device="cpu", model="softmax", num_classes=K,
                                   num_feature_dim=D))
        eng.set_weights(w_flat)
        labels, scores = eng.score(eng.encode_lines(lines))
        for replies in seen["replies"]:
            got_l, got_s = _parse_replies(replies)
            np.testing.assert_array_equal(got_l, labels)
            np.testing.assert_allclose(got_s, scores, rtol=1e-5)
