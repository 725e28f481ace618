"""The port's PS update rules and gradient wire against the JAX package's,
on the CPU: the numpy codecs, ``GradientAccumulator``, the ``KVWorker``
codec negotiation, byte accounting and FTRL opt-state ops, and
``run_ps_local`` under FTRL, int8, signSGD and accumulation.

The native servers and clients are byte-for-byte copies of the JAX
package's, so push sequences through JAX's ``KVWorker`` and the port's
give identical pulled weights (exact), and the codecs and the schedule
are compared exactly.  ``run_ps_local``: the numpy backend at rtol 1e-6,
the torch CPU step (f32 products) at rtol 1e-5, as ``test_torch_ps.py``
holds the dense path; the runs take the reference init (Q2) so both
packages start from the same weights, and keep the correct-mean update
(FTRL and the codecs refuse Q1).
"""

import contextlib
import logging
import threading

import numpy as np
import pytest

from distlr_tpu import compress as jax_compress
from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.obs.registry import family_total
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.train.ps_trainer import run_ps_local as jax_run_ps_local
from distlr_tpu_torch import compress
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.ps import KVWorker, PSRejectedError, ServerGroup
from distlr_tpu_torch.train import ps_trainer
from distlr_tpu_torch.train.ps_trainer import run_ps_local

ALPHA, BETA, L1, L2 = 0.5, 1.0, 0.01, 0.1
FTRL = {"optimizer": "ftrl", "ftrl_alpha": ALPHA, "ftrl_beta": BETA, "ftrl_l1": L1,
        "ftrl_l2": L2}


def ftrl_oracle(w0, grads, *, alpha=ALPHA, beta=BETA, l1=L1, l2=L2):
    """float32 FTRL-Proximal trajectory (``tests/test_ftrl.py``'s oracle):
    ``grads`` are full-width gradients, zeros untouched."""
    w = np.array(w0, np.float32).copy()
    z = np.zeros_like(w)
    n = np.zeros_like(w)
    a, b = np.float32(alpha), np.float32(beta)
    r1, r2 = np.float32(l1), np.float32(l2)
    for g in grads:
        g = np.asarray(g, np.float32)
        touched = g != 0
        n_new = (n + g * g).astype(np.float32)
        sigma = ((np.sqrt(n_new) - np.sqrt(n)) / a).astype(np.float32)
        z = np.where(touched, (z + g - sigma * w).astype(np.float32), z)
        n = np.where(touched, n_new, n)
        w_new = np.where(np.abs(z) <= r1, np.float32(0.0),
                         (-(z - np.sign(z) * r1) / ((b + np.sqrt(n)) / a + r2)).astype(np.float32))
        w = np.where(touched, w_new, w).astype(np.float32)
    return w


@contextlib.contextmanager
def _client_logs():
    """Records of the port's client logger (it does not propagate)."""
    records: list[logging.LogRecord] = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("distlr_tpu_torch.ps.client")
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def _jax_push_bytes():
    return (family_total("distlr_ps_push_bytes_raw_total"),
            family_total("distlr_ps_push_bytes_wire_total"))


# --- the numpy codecs -------------------------------------------------------------
class TestCodecs:
    @pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 600, 4096])
    def test_int8_encoding_equals_jax_byte_for_byte(self, n):
        v = np.random.default_rng(n).normal(size=n).astype(np.float32) * 3
        v[::11] = 0.0
        ours, theirs = compress.encode_int8(v), jax_compress.encode_int8(v)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (compress.int8_roundtrip(v).tobytes()
                == jax_compress.int8_roundtrip(v).tobytes())
        assert (compress.int8_error_bound(v).tobytes()
                == jax_compress.int8_error_bound(v).tobytes())
        assert (np.abs(compress.int8_roundtrip(v) - v) <= compress.int8_error_bound(v)).all()

    @pytest.mark.parametrize("n", [1, 8, 9, 63, 600])
    def test_sign_encoding_equals_jax_byte_for_byte(self, n):
        v = np.random.default_rng(n).normal(size=n).astype(np.float32)
        v[::4] = 0.0  # an exact zero encodes 0 and decodes -1
        bits = compress.encode_sign(v)
        assert bits.tobytes() == jax_compress.encode_sign(v).tobytes()
        assert (compress.decode_sign(bits, n).tobytes()
                == jax_compress.decode_sign(bits, n).tobytes())
        assert (compress.sign_roundtrip(v)[::4] == -1).all()

    def test_tables_and_payload_bytes_equal_jax(self):
        assert compress.CODEC_IDS == jax_compress.CODEC_IDS
        assert compress.CODECS == jax_compress.CODECS
        assert compress.QUANT_BLOCK == jax_compress.QUANT_BLOCK
        for codec in compress.CODECS:
            for n in (0, 1, 255, 256, 257, 500_000):
                assert compress.payload_bytes(codec, n) == jax_compress.payload_bytes(codec, n)
        with pytest.raises(ValueError, match="unknown codec"):
            compress.payload_bytes("gzip", 8)

    def test_decode_int8_of_zero_block_is_exact(self):
        v = np.zeros(300, np.float32)
        v[256:] = np.arange(44, dtype=np.float32)
        scales, q = compress.encode_int8(v)
        assert scales[0] == 0 and not q[:256].any()
        np.testing.assert_array_equal(compress.decode_int8(scales, q)[:256], 0.0)


# --- GradientAccumulator -------------------------------------------------------
def _twin_accumulators(dim, **kw):
    return compress.GradientAccumulator(dim, **kw), jax_compress.GradientAccumulator(dim, **kw)


class TestAccumulator:
    @pytest.mark.parametrize("kw", [
        {"start": 1, "growth": 2.0, "growth_every": 2, "max_k": 16},
        {"start": 3, "growth": 1.5, "growth_every": 3, "max_k": 7},
        {"start": 1, "growth": 1.0, "growth_every": 1, "max_k": 4},
    ])
    def test_dense_schedule_and_flushes_equal_jax(self, kw):
        ours, theirs = _twin_accumulators(32, **kw)
        rng = np.random.default_rng(0)
        for step in range(60):
            g = rng.normal(size=32).astype(np.float32)
            ours.add(g)
            theirs.add(g)
            assert (ours.batches, ours.ready) == (theirs.batches, theirs.ready)
            if ours.ready or step % 17 == 16:  # full spans and a partial one
                a, b = ours.flush_dense(), theirs.flush_dense()
                assert a.tobytes() == b.tobytes()
            assert (ours.k, ours.flushes) == (theirs.k, theirs.flushes)
        assert ours.k == kw["max_k"] or ours.flushes < 60

    @pytest.mark.parametrize("vpk", [1, 4])
    def test_keyed_flushes_equal_jax(self, vpk):
        rows = 64 // vpk
        ours, theirs = _twin_accumulators(64, start=2, growth=2.0, growth_every=2, max_k=8)
        rng = np.random.default_rng(vpk)
        for _ in range(30):
            keys = np.sort(rng.choice(rows, size=5, replace=False)).astype(np.uint64)
            g = rng.normal(size=5 * vpk).astype(np.float32)
            for acc in (ours, theirs):
                if vpk == 1:
                    acc.add_at(keys, g)
                else:
                    acc.add_rows(keys, g, vpk)
            if ours.ready:
                (ka, va), (kb, vb) = ours.flush_keyed(vpk), theirs.flush_keyed(vpk)
                assert ka.tobytes() == kb.tobytes() and va.tobytes() == vb.tobytes()
            assert (ours.k, ours.flushes) == (theirs.k, theirs.flushes)

    def test_cancelled_span_flushes_empty_and_advances(self):
        for acc in _twin_accumulators(8, start=2, max_k=4, growth_every=1):
            acc.add_at(np.array([3], np.uint64), np.array([1.0], np.float32))
            acc.add_at(np.array([3], np.uint64), np.array([-1.0], np.float32))
            rows, vals = acc.flush_keyed()
            assert rows.size == 0 and vals.size == 0
            assert acc.flushes == 1 and acc.k == 4
            assert acc.flush_keyed() is None and acc.flush_dense() is None

    @pytest.mark.parametrize("kw", [{"start": 0}, {"start": 3, "max_k": 2}, {"growth": 0.5},
                                    {"growth_every": 0}])
    def test_validation_equals_jax(self, kw):
        with pytest.raises(ValueError) as a:
            compress.GradientAccumulator(8, **kw)
        with pytest.raises(ValueError) as b:
            jax_compress.GradientAccumulator(8, **kw)
        assert str(a.value) == str(b.value)


# --- pushes through both clients ----------------------------------------------------
def _push_sequence(client_cls, hosts, d, seq, *, compress_name, sync_group=False, init=None):
    """Seed, push ``seq`` (``(vals, keys)`` pairs), pull: the weights and
    the client's ``compress_active``."""
    with client_cls(hosts, d, sync_group=sync_group, compress=compress_name) as kv:
        kv.push_init(np.zeros(d, np.float32) if init is None else init, force=True)
        for vals, keys in seq:
            kv.wait(kv.push(vals, keys))
        return kv.pull(), kv.compress_active


class TestPushesThroughBothClients:
    """The same push sequence from the port's client and from JAX's, each
    into a fresh port group: the pulled weights are equal bit for bit."""

    @pytest.mark.parametrize("codec,group_kw,lr", [
        ("int8", {}, 0.5),
        ("int8", FTRL, 0.2),
        ("none", FTRL, 0.2),
        ("signsgd", {"optimizer": "signsgd"}, 0.125),
    ])
    @pytest.mark.parametrize("num_servers", [1, 2, 3])
    def test_pulled_weights_identical(self, codec, group_kw, lr, num_servers):
        d = 600
        rng = np.random.default_rng(num_servers)
        init = rng.normal(size=d).astype(np.float32)
        seq = [(rng.normal(size=d).astype(np.float32), None) for _ in range(4)]
        keys = np.sort(rng.choice(d, size=40, replace=False)).astype(np.uint64)
        seq += [(rng.normal(size=40).astype(np.float32), keys)]
        got = []
        for cls in (KVWorker, JaxKVWorker):
            with ServerGroup(num_servers, 1, d, sync=False, learning_rate=lr,
                             **group_kw) as sg:
                got.append(_push_sequence(cls, sg.hosts, d, seq, compress_name=codec,
                                          init=init))
        (ours, ours_codec), (theirs, theirs_codec) = got
        assert ours_codec == theirs_codec == codec
        assert ours.tobytes() == theirs.tobytes()
        if group_kw.get("optimizer") == "ftrl" and codec == "none":
            dense = [v if k is None else np.zeros(d, np.float32) for v, k in seq]
            dense[-1][seq[-1][1].astype(np.int64)] = seq[-1][0]
            np.testing.assert_allclose(ours, ftrl_oracle(init, dense), rtol=1e-5, atol=1e-6)

    def test_int8_per_server_slice_blocks(self):
        """Each server's slice is its own coded frame (600 / 2 = 300 is not
        a multiple of the 256-value block)."""
        d = 600
        g = np.random.default_rng(2).normal(size=d).astype(np.float32)
        with ServerGroup(2, 1, d, sync=False, learning_rate=1.0) as sg:
            got, active = _push_sequence(KVWorker, sg.hosts, d, [(g, None)],
                                         compress_name="int8")
        assert active == "int8"
        oracle = np.concatenate([compress.int8_roundtrip(g[:300]),
                                 compress.int8_roundtrip(g[300:])])
        np.testing.assert_array_equal(got, -oracle)  # exact; an update of 0 leaves +0.0

    def test_sign_bsp_round_is_the_majority_vote(self):
        """Two workers, one BSP round: agreeing coordinates step by lr, tied
        ones stay (exact zeros vote -1)."""
        d, lr = 12, 0.25
        g1 = np.array([1, 1, -1, -1, 2, -2, 1, -1, 3, -3, 0, -1], np.float32)
        g2 = np.array([2, 1, -2, -1, -1, 2, 1, -1, 3, -3, 0, 1], np.float32)
        with ServerGroup(1, 2, d, learning_rate=lr, optimizer="signsgd") as sg, \
                KVWorker(sg.hosts, d, client_id=0, compress="signsgd") as kv0, \
                KVWorker(sg.hosts, d, client_id=1, compress="signsgd") as kv1:
            kv0.push_init(np.zeros(d, np.float32))
            t = threading.Thread(target=lambda: kv1.wait(kv1.push(g2)), daemon=True)
            t.start()
            kv0.wait(kv0.push(g1))
            t.join(timeout=30)
            assert not t.is_alive()
            got = kv0.pull()
        votes = compress.sign_roundtrip(g1) + compress.sign_roundtrip(g2)
        np.testing.assert_array_equal(got, (-np.float32(lr) * np.sign(votes)).astype(np.float32))
        np.testing.assert_array_equal(got[[4, 5, 11]], 0.0)
        assert got[10] == lr  # both exact zeros: two -1 votes

    def test_mostly_zero_sign_push_warns_once(self):
        d = 64
        sparse = np.zeros(d, np.float32)
        sparse[3] = 1.0
        with ServerGroup(1, 1, d, sync=False, learning_rate=0.1, optimizer="signsgd") as sg, \
                _client_logs() as records:
            with KVWorker(sg.hosts, d, sync_group=False, compress="signsgd") as kv:
                kv.push_init(np.zeros(d, np.float32))
                kv.wait(kv.push(sparse))
                kv.wait(kv.push(sparse))
            assert len([r for r in records if "mostly exact zeros" in r.getMessage()]) == 1
            records.clear()
            with KVWorker(sg.hosts, d, sync_group=False, client_id=1, compress="signsgd") as kv:
                kv.wait(kv.push(np.ones(d, np.float32)))
            assert not [r for r in records if "mostly exact zeros" in r.getMessage()]


# --- negotiation ---------------------------------------------------------------------
class TestNegotiation:
    def test_old_group_falls_back_to_dense_and_logs(self):
        d = 64
        g = np.random.default_rng(5).normal(size=d).astype(np.float32)
        with ServerGroup(1, 1, d, sync=False, learning_rate=1.0, compress=False) as sg, \
                _client_logs() as records, \
                KVWorker(sg.hosts, d, sync_group=False, compress="int8") as kv:
            assert kv.compress_active == "none"
            assert any("falling back to dense f32" in r.getMessage() for r in records)
            kv.push_init(np.zeros(d, np.float32))
            kv.wait(kv.push(g))
            np.testing.assert_array_equal(kv.pull(), -g)
            # a dense fallback push costs what an uncompressed one does
            assert kv.push_bytes_raw == d * 12 and kv.push_bytes_wire == 24 + d * 12

    def test_mixed_group_falls_back_like_jax(self):
        d = 64
        with ServerGroup(1, 1, d // 2, sync=False) as new, \
                ServerGroup(1, 1, d // 2, sync=False, compress=False) as old:
            hosts = f"{new.hosts},{old.hosts}"
            for cls in (KVWorker, JaxKVWorker):
                with cls(hosts, d, sync_group=False, compress="int8") as kv:
                    assert kv.compress_active == "none"

    @pytest.mark.parametrize("group_kw,codec,want", [
        ({}, "signsgd", "none"),               # sign votes need a signsgd group
        ({"optimizer": "ftrl"}, "int8", "int8"),
        ({"optimizer": "signsgd"}, "signsgd", "signsgd"),
        ({"optimizer": "signsgd"}, "int8", "int8"),
        ({}, "none", "none"),
    ])
    def test_negotiated_codec_equals_jax(self, group_kw, codec, want):
        with ServerGroup(1, 1, 16, sync=False, **group_kw) as sg:
            got = []
            for cls in (KVWorker, JaxKVWorker):
                with cls(sg.hosts, 16, sync_group=False, compress=codec) as kv:
                    got.append(kv.compress_active)
        assert got == [want, want]

    def test_reconnect_renegotiates(self):
        d = 300
        g = np.random.default_rng(6).normal(size=d).astype(np.float32)
        with ServerGroup(1, 1, d, sync=False, learning_rate=1.0) as sg, \
                KVWorker(sg.hosts, d, sync_group=False, compress="int8") as kv:
            kv.push_init(np.zeros(d, np.float32))
            kv.compress_active = None
            kv.reconnect()
            assert kv.compress_active == "int8"
            kv.wait(kv.push(g))
            np.testing.assert_array_equal(kv.pull(), -compress.int8_roundtrip(g))

    def test_unknown_codec_rejected_like_jax(self):
        for cls in (KVWorker, JaxKVWorker):
            with pytest.raises(ValueError, match="compress must be one of"):
                cls("127.0.0.1:1", 8, compress="gzip")


# --- byte accounting ------------------------------------------------------------------
class TestByteAccounting:
    @pytest.mark.parametrize("codec", ["none", "int8", "signsgd"])
    @pytest.mark.parametrize("num_servers", [1, 2])
    def test_dense_and_keyed_counters_exact_and_equal_jax(self, codec, num_servers):
        """Header (24 a server) + keys + coded payload a delivered push,
        equal to the JAX client's registry counters for the same pushes."""
        d = 1024
        rng = np.random.default_rng(7)
        keys = np.sort(rng.choice(d, size=100, replace=False)).astype(np.uint64)
        pushes = [(rng.normal(size=d).astype(np.float32), None) for _ in range(3)]
        pushes += [(rng.normal(size=100).astype(np.float32), keys)]
        opt = {"optimizer": "signsgd"} if codec == "signsgd" else {}
        counts = []
        for cls in (KVWorker, JaxKVWorker):
            with ServerGroup(num_servers, 1, d, sync=False, **opt) as sg, \
                    cls(sg.hosts, d, sync_group=False, compress=codec) as kv:
                kv.push_init(np.zeros(d, np.float32))
                before = _jax_push_bytes()
                for vals, k in pushes:
                    kv.wait(kv.push(vals, k))
                after = _jax_push_bytes()
                counts.append((kv.push_bytes_raw, kv.push_bytes_wire) if cls is KVWorker
                              else (after[0] - before[0], after[1] - before[1]))
        assert counts[0] == counts[1]
        raw, wire_bytes = counts[0]
        per = d // num_servers
        lo = keys < per if num_servers == 2 else np.ones(100, bool)
        slices = [int(lo.sum()), int((~lo).sum())] if num_servers == 2 else [100]
        if codec == "none":
            dense_wire = 24 * num_servers + 12 * d
            keyed_wire = sum(24 + 12 * n for n in slices)
        else:
            # a dense push rides one vals_per_key row a server
            dense_wire = sum(24 + 8 + compress.payload_bytes(codec, per)
                             for _ in range(num_servers))
            keyed_wire = sum(24 + 8 * n + compress.payload_bytes(codec, n) for n in slices)
        assert raw == 3 * 12 * d + 12 * 100
        assert wire_bytes == 3 * dense_wire + keyed_wire
        if codec == "int8":
            assert raw / wire_bytes > 8

    def test_ratio_before_and_after_the_first_push(self):
        with ServerGroup(1, 1, 512, sync=False) as sg, \
                KVWorker(sg.hosts, 512, sync_group=False, compress="int8") as kv:
            assert kv.compress_ratio is None
            kv.push_init(np.zeros(512, np.float32))
            kv.wait(kv.push(np.ones(512, np.float32)))
            assert kv.compress_ratio == 512 * 12 / (24 + 8 + compress.payload_bytes("int8", 512))

    @pytest.mark.parametrize("dim,servers", [(4096, 2), (1_000_000, 2), (999, 3), (1021, 2),
                                             (600, 3)])
    def test_dense_row_encoding_equals_jax(self, dim, servers):
        """The largest aligned vals_per_key, or flat keys where none aligns
        (a prime dim)."""
        ours = KVWorker.__new__(KVWorker)
        theirs = JaxKVWorker.__new__(JaxKVWorker)
        for kv in (ours, theirs):
            kv.dim, kv.num_servers, kv._dense_rows = dim, servers, None
            kv._all_keys = np.arange(dim, dtype=np.uint64)
        (ka, va), (kb, vb) = ours._dense_row_encoding(), theirs._dense_row_encoding()
        assert va == vb and ka.tobytes() == kb.tobytes()
        assert (va == 1) == (dim == 1021)


# --- FTRL opt-state ops -------------------------------------------------------------
class TestOptState:
    def test_split_trajectory_equals_the_unbroken_one(self):
        """Pull z, n and w, seed a fresh group with them, carry on: the
        weights equal the unbroken run's bit for bit."""
        d = 40
        rng = np.random.default_rng(11)
        w0 = rng.normal(size=d).astype(np.float32)
        grads = [rng.normal(size=d).astype(np.float32) for _ in range(8)]
        grads[2][::3] = 0.0
        with ServerGroup(1, 1, d, sync=False, **FTRL) as sg, KVWorker(sg.hosts, d) as kv:
            kv.push_init(w0)
            for g in grads:
                kv.wait(kv.push(g))
            unbroken = kv.pull()
        with ServerGroup(1, 1, d, sync=False, **FTRL) as sg, KVWorker(sg.hosts, d) as kv:
            kv.push_init(w0)
            for g in grads[:4]:
                kv.wait(kv.push(g))
            w_mid, (z, n) = kv.pull(), kv.pull_opt_state()
        with ServerGroup(1, 1, d, sync=False, **FTRL) as sg, KVWorker(sg.hosts, d) as kv:
            kv.push_init(w_mid)
            # the seeding push initialized the group: z and n overwrite
            kv.push_init_opt_state(z, n, force=True)
            for g in grads[4:]:
                kv.wait(kv.push(g))
            split = kv.pull()
        with ServerGroup(1, 1, d, sync=False, **FTRL) as sg, KVWorker(sg.hosts, d) as kv:
            kv.push_init(w_mid)  # the weights alone: a warm restart
            for g in grads[4:]:
                kv.wait(kv.push(g))
            warm = kv.pull()
        assert split.tobytes() == unbroken.tobytes()
        assert not np.array_equal(warm, unbroken)
        np.testing.assert_allclose(unbroken, ftrl_oracle(w0, grads), rtol=1e-5, atol=1e-6)

    def test_opt_state_equals_jax_clients(self):
        d = 24
        g = np.random.default_rng(3).normal(size=d).astype(np.float32)
        states = []
        for cls in (KVWorker, JaxKVWorker):
            with ServerGroup(1, 1, d, sync=False, **FTRL) as sg, cls(sg.hosts, d) as kv:
                kv.push_init(np.zeros(d, np.float32))
                kv.wait(kv.push(g))
                states.append(kv.pull_opt_state())
        for a, b in zip(*states):
            assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(states[0][1], g * g)

    def test_rejected_on_sgd_server_without_poisoning(self):
        with ServerGroup(1, 1, 8, sync=False) as sg, KVWorker(sg.hosts, 8) as kv:
            kv.push_init(np.arange(8, dtype=np.float32))
            with pytest.raises(PSRejectedError, match="rejected"):
                kv.pull_opt_state()
            with pytest.raises(PSRejectedError):
                kv.push_init_opt_state(np.zeros(8), np.zeros(8))
            np.testing.assert_array_equal(kv.pull(), np.arange(8, dtype=np.float32))

    def test_multi_server_handle_and_bad_shapes_refused(self):
        with ServerGroup(2, 1, 8, sync=False, optimizer="ftrl") as sg, \
                KVWorker(sg.hosts, 8) as kv:
            with pytest.raises(ValueError, match="ONE server"):
                kv.pull_opt_state()
            with pytest.raises(ValueError, match="ONE server"):
                kv.push_init_opt_state(np.zeros(8), np.zeros(8))
        with ServerGroup(1, 1, 8, sync=False, optimizer="ftrl") as sg, \
                KVWorker(sg.hosts, 8) as kv:
            with pytest.raises(ValueError, match="dim=8"):
                kv.push_init_opt_state(np.zeros(7), np.zeros(8))


# --- run_ps_local ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def ps_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pswire")
    write_synthetic_shards(str(d), 1200, 16, num_parts=2, seed=4, sparsity=0.0)
    return str(d)


def _both_cfgs(data_dir, **kw):
    common = dict(data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                  num_iteration=6, learning_rate=0.3, l2_c=0.5, batch_size=100,
                  test_interval=3, reference_rng_init=True, ps_compute_backend="numpy")
    common.update(kw)
    return Config(device="cpu", **common), JaxConfig(**common)


_MODES = {
    "ftrl": {"ps_optimizer": "ftrl", "ftrl_alpha": ALPHA, "ftrl_l1": L1, "ftrl_l2": L2},
    "int8": {"ps_compress": "int8"},
    "signsgd": {"ps_compress": "signsgd", "learning_rate": 0.02},
    "ftrl_int8": {"ps_optimizer": "ftrl", "ps_compress": "int8", "ftrl_alpha": ALPHA},
    "accum": {"ps_accum_start": 1, "ps_accum_max": 4, "ps_accum_growth_every": 2},
    "accum_int8": {"ps_accum_start": 2, "ps_accum_max": 3, "ps_accum_growth_every": 1,
                   "ps_compress": "int8"},
}


class TestRunPsLocalParity:
    @pytest.mark.parametrize("mode", list(_MODES))
    def test_sync_numpy_step(self, ps_data_dir, mode):
        ours_cfg, jax_cfg = _both_cfgs(ps_data_dir, **_MODES[mode])
        ours_ev, jax_ev = [], []
        rep = {}
        ours = run_ps_local(ours_cfg, eval_fn=lambda e, a: ours_ev.append((e, a)), report=rep)
        ref = jax_run_ps_local(jax_cfg, eval_fn=lambda e, a: jax_ev.append((e, a)))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert ours_ev == pytest.approx(jax_ev, abs=1e-6)
        want = _MODES[mode].get("ps_compress", "none")
        assert all(r["compress_active"] == want for r in rep.values())

    @pytest.mark.parametrize("mode", list(_MODES))
    def test_async_single_worker_numpy_step(self, ps_data_dir, mode):
        """One async worker has no races: deterministic, equal to JAX's."""
        ours_cfg, jax_cfg = _both_cfgs(ps_data_dir, sync_mode=False, num_workers=1,
                                       **_MODES[mode])
        np.testing.assert_allclose(run_ps_local(ours_cfg)[0], jax_run_ps_local(jax_cfg)[0],
                                   rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("mode", ["ftrl", "int8", "signsgd", "accum_int8"])
    def test_torch_cpu_step(self, ps_data_dir, mode):
        ours_cfg, jax_cfg = _both_cfgs(ps_data_dir, ps_compute_backend="cpu",
                                       compute_dtype="float32", **_MODES[mode])
        for a, b in zip(run_ps_local(ours_cfg), jax_run_ps_local(jax_cfg)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_two_async_workers_with_accumulation_push_the_schedule(self, ps_data_dir):
        """Async Hogwild: the servers count exactly the schedule's pushes
        (each epoch's spans, its partial last one included) plus the
        seeding push."""
        cfg, _ = _both_cfgs(ps_data_dir, sync_mode=False, num_iteration=4,
                            **_MODES["accum_int8"])
        rep = {}
        weights = run_ps_local(cfg, report=rep)
        sched = {}
        for r in range(2):
            acc = compress.GradientAccumulator(16, start=2, growth_every=1, max_k=3)
            with open(f"{ps_data_dir}/train/part-00{r + 1}") as f:
                batches = -(-sum(1 for line in f if line.strip()) // 100)
            for _ in range(4):
                for _ in range(batches):
                    acc.add(np.ones(16, np.float32))
                    if acc.ready:
                        acc.flush_dense()
                acc.flush_dense()
            sched[r] = acc.flushes
            assert rep[r]["accum_flushes"] == acc.flushes and rep[r]["accum_k"] == acc.k
        assert rep[0]["group_pushes"] == sum(sched.values()) + 1
        assert all(np.isfinite(w).all() for w in weights)

    def test_uncompressed_run_keeps_its_wire(self, ps_data_dir):
        """``none`` and no accumulation: the fused sync round a batch, whose
        frames are the dense f32 ones (24 B of header a server, 12 B a
        coordinate), and the weights of the JAX package's run."""
        ours_cfg, jax_cfg = _both_cfgs(ps_data_dir)
        rep = {}
        ours = run_ps_local(ours_cfg, report=rep)
        for a, b in zip(ours, jax_run_ps_local(jax_cfg)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for r in rep.values():
            assert r["compress_active"] == "none" and "push_ms" not in r
            assert r["push_pull_count"] == r["steps"]
            assert r["push_bytes_wire"] == r["steps"] * (2 * 24 + 12 * 16)
            assert r["push_bytes_raw"] == r["steps"] * 12 * 16

    def test_sync_keyed_span_that_cancels_still_votes(self, tmp_path):
        """A sync keyed span whose gradients cancel to zero pushes an empty
        frame: without that vote the other worker's BSP round would hang
        (the run has a timeout of its own)."""
        cfg = Config(device="cpu", data_dir=str(tmp_path), model="sparse_lr",
                     num_feature_dim=64, num_workers=2, num_servers=2, ps_timeout_ms=20_000,
                     ps_accum_max=2, ps_accum_start=2, ps_compute_backend="numpy")
        pushes = []

        class _Acc(compress.GradientAccumulator):
            def flush_keyed(self, vpk=1):
                res = super().flush_keyed(vpk)
                if res is not None and not pushes:
                    res = (res[0][:0], res[1][:0])  # the run's first span cancels
                pushes.append(None if res is None else res[0].size)
                return res

        orig = ps_trainer.GradientAccumulator
        ps_trainer.GradientAccumulator = _Acc
        try:
            from distlr_tpu_torch.data import hashing

            hashing.write_ctr_shards(str(tmp_path), 400, 4, 50, 64, 2, seed=1)
            weights = run_ps_local(cfg.replace(num_iteration=2, batch_size=50))
        finally:
            ps_trainer.GradientAccumulator = orig
        assert 0 in pushes and all(np.isfinite(w).all() for w in weights)
        np.testing.assert_array_equal(weights[0], weights[1])


# --- the PS worker's plumbing ----------------------------------------------------------
class TestWorkerPlumbing:
    @pytest.mark.parametrize("kw,want", [
        ({}, "sgd"), ({"ps_optimizer": "ftrl"}, "ftrl"), ({"ps_compress": "int8"}, "sgd"),
        ({"ps_compress": "signsgd"}, "signsgd"),
        ({"ps_optimizer": "ftrl", "ps_compress": "int8"}, "ftrl"),
    ])
    def test_server_optimizer_equals_jax(self, kw, want):
        from distlr_tpu.train.ps_trainer import server_optimizer as jax_server_optimizer

        assert ps_trainer.server_optimizer(Config(device="cpu", **kw)) == want
        assert jax_server_optimizer(JaxConfig(**kw)) == want

    def test_run_ps_local_spawns_the_configured_rule(self, ps_data_dir, monkeypatch):
        seen = {}
        orig = ServerGroup.__init__

        def spy(self, *a, **kw):
            seen.update(kw)
            orig(self, *a, **kw)

        monkeypatch.setattr(ServerGroup, "__init__", spy)
        cfg, _ = _both_cfgs(ps_data_dir, num_iteration=1, **_MODES["ftrl"])
        run_ps_local(cfg)
        assert seen["optimizer"] == "ftrl"
        assert (seen["ftrl_alpha"], seen["ftrl_beta"], seen["ftrl_l1"], seen["ftrl_l2"]) == (
            ALPHA, 1.0, L1, L2)
