"""The port's native code on the CPU: the libsvm tokenizer against its
pure-Python twin and the JAX package's, ``DataIter`` against the JAX
package's, and the KV client and server against the JAX package's (the
same bytes pulled after the same pushes, in both pairings).

Every comparison is exact: the same parse or the same float32 server
arithmetic on the same inputs.
"""

import threading

import numpy as np
import pytest

from distlr_tpu.data import DataIter as JaxDataIter
from distlr_tpu.data import _native as jax_native
from distlr_tpu.data.libsvm import _parse_python as jax_parse_python
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu_torch.data import DataIter, _native, libsvm, native_available
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.ps import build as ps_build
from distlr_tpu_torch.utils import native


def _blob(seed: int, rows: int = 400) -> bytes:
    """libsvm text with signed and scientific values, +1/-1/0/2/1.0
    labels, 1-based ascending indices, empty and comment-only lines,
    trailing comments and CRLF ends."""
    rng = np.random.default_rng(seed)
    labels = ("+1", "-1", "0", "2", "1.0", "1")
    lines = []
    for i in range(rows):
        idx = np.sort(rng.choice(200, int(rng.integers(0, 9)), replace=False)) + 1
        vals = rng.standard_normal(len(idx)) * 10.0 ** rng.integers(-8, 8, len(idx))
        fmt = ("{:.6g}", "{:+.3e}", "{:g}")[i % 3]
        feats = " ".join(f"{j}:{fmt.format(v)}" for j, v in zip(idx, vals))
        line = f"{labels[i % len(labels)]} {feats}"
        if i % 17 == 0:
            line += " # a trailing comment"
        if i % 23 == 0:
            line += "\r"
        lines.append(line)
        if i % 29 == 0:
            lines.append("")
        if i % 31 == 0:
            lines.append("   \t")
    return ("\n".join(lines) + "\n").encode()


class TestNativeParser:
    def test_native_is_available(self):
        assert native_available(), "the port's native libsvm parser should build here"

    def test_library_is_the_ports_hashed_build(self):
        path = native.build("libdistlr_torch_libsvm", [_native.SOURCE], shared=True,
                            flags=_native.FLAGS)
        assert path.parent == native.default_build_dir()
        assert path.name.startswith("libdistlr_torch_libsvm-") and path.suffix == ".so"
        assert "distlr_tpu/data" not in str(path)

    @pytest.mark.parametrize("multiclass", [False, True])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_native_python_and_jax_agree_bit_for_bit(self, seed, multiclass):
        blob = _blob(seed)
        ours = _native.parse_libsvm_bytes(blob, multiclass)
        python = libsvm._parse_python(blob.decode().splitlines(), multiclass)
        jax_native_out = jax_native.parse_libsvm_bytes(blob, multiclass)
        jax_python = jax_parse_python(blob.decode().splitlines(), multiclass)
        for got, *refs in zip(ours, python, jax_native_out, jax_python):
            for ref in refs:
                assert got.dtype == ref.dtype
                np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))

    def test_label_rule_indices_and_values(self):
        blob = b"1 1:2.5 3:-1e2\n\n-1 2:4\n0 5:+7.5E-3 # c\n1.0 1:1\n2 4:-0\n"
        labels, row_ptr, cols, vals = _native.parse_libsvm_bytes(blob, False)
        np.testing.assert_array_equal(labels, [1, 0, 0, 1, 0])  # label != 1 -> 0
        np.testing.assert_array_equal(row_ptr, [0, 2, 3, 4, 5, 6])
        np.testing.assert_array_equal(cols, [0, 2, 1, 4, 0, 3])  # 1-based -> 0-based
        np.testing.assert_array_equal(vals, np.float32([2.5, -100, 4, 7.5e-3, 1, -0.0]))
        assert np.signbit(vals[-1])
        mc_labels = _native.parse_libsvm_bytes(blob, True)[0]
        np.testing.assert_array_equal(mc_labels, [1, -1, 0, 1, 2])

    @pytest.mark.parametrize("bad", [b"1 notafeature\n", b"1 3:\n", b"x 1:2\n", b"1 :2\n"])
    def test_malformed_rows_raise_in_every_parser(self, bad):
        with pytest.raises(ValueError, match="malformed"):
            _native.parse_libsvm_bytes(bad, False)
        with pytest.raises(ValueError):
            libsvm._parse_python(bad.decode().splitlines(), False)
        with pytest.raises(ValueError, match="malformed"):
            libsvm.parse_libsvm_lines(bad, 8)

    def test_file_parse_routes_through_native(self, tmp_path, monkeypatch):
        p = tmp_path / "f"
        p.write_bytes(_blob(3))
        calls = []
        real = _native.parse_libsvm_bytes
        monkeypatch.setattr(_native, "parse_libsvm_bytes",
                            lambda data, mc: calls.append(len(data)) or real(data, mc))
        X, y = libsvm.parse_libsvm_file(str(p), 200)
        assert calls == [len(_blob(3))]
        lines_X, lines_y = libsvm.parse_libsvm_lines(_blob(3).decode().splitlines(), 200)
        np.testing.assert_array_equal(X, lines_X)
        np.testing.assert_array_equal(y, lines_y)

    def test_build_failure_falls_back_to_python(self, monkeypatch):
        def broken(data, mc):
            raise RuntimeError("g++ failed")

        monkeypatch.setattr(libsvm, "_NATIVE", _native)
        monkeypatch.setattr(_native, "parse_libsvm_bytes", broken)
        X, y = libsvm.parse_libsvm_lines(b"1 1:2\n-1 2:3\n", 2)
        np.testing.assert_array_equal(X, [[2, 0], [0, 3]])
        assert libsvm._NATIVE is None and not native_available()


class TestDataIter:
    @pytest.mark.parametrize("batch,kw", [
        (-1, {}), (4, {}), (4, {"wrap_compat": True}), (8, {"wrap_compat": True}),
        (4, {"drop_remainder": True}), (5, {"shuffle": True, "seed": 7}), (3, {}),
    ])
    def test_batches_equal_jax(self, batch, kw):
        n = 10 if batch != 8 else 3
        X = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        y = np.arange(n, dtype=np.int32) % 2
        ours, ref = DataIter(X, y, batch, **kw), JaxDataIter(X, y, batch, **kw)
        assert ours.num_batches == ref.num_batches
        for _ in range(2):  # two epochs
            got, want = list(ours), list(ref)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for u, v in zip(a, b):
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
            ours.reset()
            ref.reset()

    def test_from_file_equals_jax(self, tmp_path):
        p = tmp_path / "part-001"
        p.write_bytes(_blob(4))
        a = DataIter.from_file(str(p), 200, 64, wrap_compat=True)
        b = JaxDataIter.from_file(str(p), 200, 64, wrap_compat=True)
        for u, v in zip(next(iter(a)), next(iter(b))):
            np.testing.assert_array_equal(u, v)


class TestBuild:
    def test_ps_artifacts_are_the_ports_hashed_builds(self):
        server, client = ps_build.server_binary(), ps_build.client_lib()
        for path, stem in ((server, "distlr_torch_kv_server-"), (client, "libdistlr_torch_kv-")):
            assert path.parent == native.default_build_dir() and path.name.startswith(stem)
        assert client.suffix == ".so" and server.suffix == ""

    def test_edited_source_hashes_anew(self, tmp_path):
        src = tmp_path / "x.cc"
        src.write_text("int f() { return 1; }\n")
        a = native.artifact_path("x", [src], native.CXX_FLAGS, tmp_path, ".so")
        src.write_text("int f() { return 2; }\n")
        b = native.artifact_path("x", [src], native.CXX_FLAGS, tmp_path, ".so")
        assert a != b and a.parent == b.parent == tmp_path

    def test_concurrent_builds_share_one_artifact(self, tmp_path):
        src = tmp_path / "y.cc"
        src.write_text('extern "C" int f() { return 3; }\n')
        out = []
        threads = [threading.Thread(target=lambda: out.append(
            native.build("y", [src], shared=True, build_dir=tmp_path))) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(out) == 3 and len(set(out)) == 1 and out[0].exists()
        assert sorted(p.name for p in tmp_path.glob("y-*")) == [out[0].name]

    def test_compiler_failure_raises_with_its_output(self, tmp_path):
        src = tmp_path / "bad.cc"
        src.write_text("this is not C++\n")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cc"):
            native.build("bad", [src], shared=True, build_dir=tmp_path)
        assert not list(tmp_path.glob("bad-*"))


def _pushes_and_pulls(make_client, hosts: str, sync: bool):
    """The same op sequence from two workers: init, then rounds of pushes
    (concurrent in sync mode: the reply is the barrier), a fused
    push_pull round, and keyed pulls; returns every pulled array."""
    dim = 10
    rng = np.random.default_rng(5)
    grads = rng.standard_normal((3, 2, dim)).astype(np.float32)
    kv = [make_client(hosts, dim, r) for r in range(2)]
    pulled = []
    try:
        kv[0].push_init(np.linspace(-1, 1, dim).astype(np.float32))
        t = threading.Thread(target=kv[1].barrier)
        t.start()
        kv[0].barrier()
        t.join(timeout=20)
        for rnd in range(2):
            if sync:
                t = threading.Thread(target=kv[1].push, args=(grads[rnd, 1],))
                t.start()
                kv[0].push(grads[rnd, 0])
                t.join(timeout=20)
            else:
                kv[0].push(grads[rnd, 0])
                kv[1].push(grads[rnd, 1])
            pulled.append(kv[rnd % 2].pull())
        out = {}
        t = threading.Thread(target=lambda: out.update(b=kv[1].push_pull(grads[2, 1])))
        if sync:
            t.start()
            out["a"] = kv[0].push_pull(grads[2, 0])
            t.join(timeout=20)
        else:
            out["a"] = kv[0].push_pull(grads[2, 0])
            t.start()
            t.join(timeout=20)
        pulled += [out["a"], out["b"], kv[0].pull(np.array([0, 3, 4, 9], np.uint64))]
    finally:
        for k in kv:
            k.close()
    return pulled


class TestCrossWire:
    """Each client against the other package's server group: the wire
    bytes are the same protocol, so the pulled bytes are identical."""

    @pytest.mark.parametrize("sync", [True, False])
    def test_port_client_jax_servers_and_back(self, sync):
        group_kw = dict(learning_rate=0.5, sync=sync)

        def port_client(hosts, dim, r):
            return KVWorker(hosts, dim, client_id=r, timeout_ms=20_000, sync_group=sync)

        def jax_client(hosts, dim, r):
            return JaxKVWorker(hosts, dim, client_id=r, timeout_ms=20_000, sync_group=sync)

        runs = {}
        for name, group_cls, client in (("port_on_jax", JaxServerGroup, port_client),
                                        ("jax_on_port", ServerGroup, jax_client),
                                        ("port_on_port", ServerGroup, port_client),
                                        ("jax_on_jax", JaxServerGroup, jax_client)):
            with group_cls(3, 2, 10, **group_kw) as g:
                runs[name] = _pushes_and_pulls(client, g.hosts, sync)
        ref = runs.pop("jax_on_jax")
        for name, pulled in runs.items():
            assert len(pulled) == len(ref)
            for got, want in zip(pulled, ref):
                assert got.dtype == want.dtype == np.float32
                assert got.tobytes() == want.tobytes(), name

    def test_stats_fields_match_jax(self):
        from distlr_tpu.ps.client import STATS_FIELDS as JAX_STATS
        from distlr_tpu_torch.ps.client import STATS_FIELDS

        assert STATS_FIELDS == JAX_STATS
        with ServerGroup(2, 1, 8) as g, KVWorker(g.hosts, 8) as ours, \
                JaxKVWorker(g.hosts, 8) as theirs:
            ours.push(np.ones(8, np.float32))
            a, b = ours.stats(1), theirs.stats(1)
            assert {k: a[k] for k in STATS_FIELDS if not k.startswith("cpu_")} == \
                   {k: b[k] for k in STATS_FIELDS if not k.startswith("cpu_")}
