"""The port's distlr-lint passes against the JAX package's, on the CPU.

* wire parity: the two byte-equal ``kv_protocol.h`` parse to equal
  dicts; JAX's seeded fixtures (value mismatch, one-sided constant, raw
  literal, stats-field drift, store constant / struct size / mirror
  deletion) run through both packages' lints on their own trees and give
  the same findings once the package prefix is mapped;
* concurrency: the seeded unlocked write, lock cycle, ``_locked`` suffix
  and baseline hygiene fixtures give both packages the same findings,
  and the port's tree is clean under its own baseline, every entry
  keyed on ``distlr_tpu_torch/`` and justified;
* print ban and config/CLI/docs parity the same way; ``generate()``'s
  field, flag and default columns equal JAX's for every shared field;
* the runner: exit 0 on the port's tree (the ``sched`` pass itself runs
  in ``tests/test_torch_schedcheck_scenarios.py`` at the same depth, and
  ``--only protocol`` / ``--only fleetsim`` run those two here, so the
  runner test checks all three are called and does not re-run them),
  ``--list-passes`` lists JAX's eight, and ``--only protocol`` /
  ``--only fleetsim`` exit 0 with JAX's findings;
* regression tests for the races the lints found: the membership epoch
  read under the lock, chaos stop reaping storming connections, and the
  two the port's first run found (``ShadowMirror.stats`` and the
  reloader's degraded-poll warning).
"""

from __future__ import annotations

import os
import shutil
import socket
import textwrap
import threading
import time

import pytest

from distlr_tpu.analysis import baseline as jax_baseline
from distlr_tpu.analysis import concurrency as jax_concurrency
from distlr_tpu.analysis import config_doc as jax_config_doc
from distlr_tpu.analysis import printban as jax_printban
from distlr_tpu.analysis import wire_parity as jax_wire
from distlr_tpu.analysis.__main__ import PASSES as JAX_PASSES
from distlr_tpu.analysis.__main__ import run_pass as jax_run_pass
from distlr_tpu_torch.analysis import baseline, concurrency, config_doc, printban, wire_parity
from distlr_tpu_torch.analysis.__main__ import PASSES
from distlr_tpu_torch.analysis.__main__ import main as lint_main
from distlr_tpu_torch.analysis.report import repo_root

REPO = repo_root()

# ---------------------------------------------------------------------------
# wire parity
# ---------------------------------------------------------------------------

_WIRE_FILES = ("ps/wire.py", "ps/client.py", "ps/membership.py", "ps/server.py",
               "ps/store.py", "compress/codecs.py", "chaos/proxy.py")
#: each package's protocol model, a framing site like any other
_PROTOCOL_FILES = ("analysis/protocol/spec.py", "analysis/protocol/checker.py",
                   "analysis/protocol/mutants.py", "analysis/protocol/conformance.py")


def _wire_fixture(root, pkg, mutate_header=None, mutate_client=None, mutate_store=None,
                  drop_store=False):
    """One package's header + mirrors copied under ``root``, with the
    same seeded mutation either package's fixture gets."""
    files = _WIRE_FILES + _PROTOCOL_FILES
    for rel in files + ("ps/native/kv_protocol.h",):
        dst = root / pkg / rel
        os.makedirs(dst.parent, exist_ok=True)
        shutil.copy(os.path.join(REPO, pkg, rel), dst)
    for rel, fn in (("ps/native/kv_protocol.h", mutate_header), ("ps/client.py", mutate_client),
                    ("ps/store.py", mutate_store)):
        if fn is not None:
            path = root / pkg / rel
            path.write_text(fn(path.read_text()))
    if drop_store:
        os.remove(root / pkg / "ps/store.py")
    return str(root)


def _norm(findings, root):
    """(key, message) pairs with the fixture root and the package prefix
    mapped away: the locations' line numbers are each package's own."""
    return sorted((f.key.replace("distlr_tpu_torch/", "distlr_tpu/"),
                   f.message.replace(root, "<root>").replace("distlr_tpu_torch", "distlr_tpu"))
                  for f in findings)


_MUTATIONS = {
    "value_mismatch": (dict(mutate_header=lambda h: h.replace("kQuantBlock = 256",
                                                              "kQuantBlock = 128")),
                       "value-mismatch:kQuantBlock"),
    "one_sided_constant": (dict(mutate_header=lambda h: h.replace(
        "constexpr uint64_t kQuantBlock = 256;",
        "constexpr uint64_t kQuantBlock = 256;\nconstexpr uint64_t kNewKnob = 7;")),
        "header-only:kNewKnob"),
    "raw_literal": (dict(mutate_client=lambda s: s.replace(
        "range(min(wire.MAX_VALS_PER_KEY, self.dim), 1, -1)",
        "range(min(4096, self.dim), 1, -1)")),
        "raw-literal:distlr_tpu/ps/client.py:kMaxValsPerKey"),
    "stats_fields_drift": (dict(mutate_client=lambda s: s.replace('    "epoch",\n', "")),
                           "stats-fields-length"),
    "store_constant": (dict(mutate_store=lambda s: s.replace("STORE_VERSION = 1",
                                                             "STORE_VERSION = 2")),
                       "store-value-mismatch:kStoreVersion"),
    "store_struct_size": (dict(mutate_store=lambda s: s.replace(
        'WAL_RECORD_STRUCT = struct.Struct("<QIBBHI")',
        'WAL_RECORD_STRUCT = struct.Struct("<QIBBHII")')),
        "store-struct-size:WAL_RECORD_STRUCT"),
    "store_mirror_deletion": (dict(drop_store=True), "store-mirror-missing"),
}


class TestWireParity:
    def test_port_tree_is_clean(self):
        assert wire_parity.check() == []

    def test_byte_equal_headers_parse_to_equal_dicts(self):
        port_hdr = os.path.join(REPO, "distlr_tpu_torch/ps/native/kv_protocol.h")
        jax_hdr = os.path.join(REPO, "distlr_tpu/ps/native/kv_protocol.h")
        assert wire_parity.header_path() == port_hdr
        got = wire_parity.parse_header()
        assert got == jax_wire.parse_header(jax_hdr)
        assert got["kMagic"][0] == 0xD157C0DE and got["sizeof(MsgHeader)"][0] == 24

    def test_mirror_maps_equal_jax(self):
        assert wire_parity.HEADER_TO_WIRE == jax_wire.HEADER_TO_WIRE
        assert wire_parity.HEADER_TO_STORE == jax_wire.HEADER_TO_STORE
        assert wire_parity.WIRE_ONLY == jax_wire.WIRE_ONLY
        # the port's raw-literal sites are JAX's, protocol model included
        assert wire_parity.MIRROR_SITES == tuple(
            s.replace("distlr_tpu/", "distlr_tpu_torch/") for s in jax_wire.MIRROR_SITES)

    @pytest.mark.parametrize("name", sorted(_MUTATIONS))
    def test_seeded_fixture_gives_jax_findings(self, tmp_path, name):
        kw, want = _MUTATIONS[name]
        jroot = _wire_fixture(tmp_path / "jax", "distlr_tpu", **kw)
        proot = _wire_fixture(tmp_path / "torch", "distlr_tpu_torch", **kw)
        jf = jax_wire.check(root=jroot)
        pf = wire_parity.check(root=proot)
        assert _norm(pf, proot) == _norm(jf, jroot)
        assert any(k.startswith(want.replace("distlr_tpu/", "distlr_tpu_torch/"))
                   for k in (f.key for f in pf)), [f.key for f in pf]


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------

_CONCURRENCY_FIXTURES = {
    "unlocked_write": ("""
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def safe_bump(self):
                with self._lock:
                    self.n += 1

            def racy_bump(self):
                self.n += 1
    """, "unlocked-write:fixture_pkg/mod.py:Counter.n:racy_bump"),
    "lock_cycle": ("""
        import threading

        class A:
            def __init__(self, b: "B"):
                self._lock = threading.Lock()
                self.b = b

            def outer(self):
                with self._lock:
                    self.b.enter()

            def enter(self):
                with self._lock:
                    pass

        class B:
            def __init__(self, a: A):
                self._lock = threading.Lock()
                self.a = a

            def outer(self):
                with self._lock:
                    self.a.enter()

            def enter(self):
                with self._lock:
                    pass
    """, "lock-cycle:"),
    "locked_suffix": ("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self.x += 1
    """, None),
}


def _pkg(tmp_path, source: str) -> str:
    pkg = tmp_path / "fixture_pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    return str(pkg)


def _render(findings):
    return [f.render() for f in findings]


class TestConcurrencyLint:
    def test_port_tree_is_clean_under_its_baseline(self):
        assert concurrency.check() == []

    def test_every_baseline_entry_is_the_ports_and_justified(self):
        assert baseline.default_path() == os.path.join(
            REPO, "distlr_tpu_torch/analysis/concurrency_baseline.toml")
        entries, problems = baseline.load_baseline()
        assert problems == [] and entries
        for e in entries:
            assert e.key.split(":", 2)[1].startswith("distlr_tpu_torch/"), e.key
            assert e.justification.strip() and e.scenario

    @pytest.mark.parametrize("name", sorted(_CONCURRENCY_FIXTURES))
    def test_seeded_fixture_gives_jax_findings(self, tmp_path, name):
        source, want = _CONCURRENCY_FIXTURES[name]
        pkg = _pkg(tmp_path, source)
        none = str(tmp_path / "none.toml")
        got = concurrency.check(pkg_dir=pkg, baseline_path=none)
        assert _render(got) == _render(jax_concurrency.check(pkg_dir=pkg, baseline_path=none))
        if want is None:
            assert got == []
        else:
            assert any(f.key.startswith(want) for f in got), [f.key for f in got]

    @pytest.mark.parametrize("body,want", [
        ('[[suppress]]\nkey = "unlocked-write:x"\n', "baseline-no-justification"),
        ('[[suppress]]\nkey = "unlocked-read:x"\njustification = "why"\n',
         "baseline-no-scenario"),
        ('[[suppress]]\njustification = "why"\n', "baseline-no-key"),
        ('key = "x"\n', "baseline-parse"),
    ])
    def test_baseline_hygiene_equals_jax(self, tmp_path, body, want):
        p = tmp_path / "b.toml"
        p.write_text(body)
        entries, problems = baseline.load_baseline(str(p))
        j_entries, j_problems = jax_baseline.load_baseline(str(p))
        assert _render(problems) == _render(j_problems)
        assert entries == j_entries == []
        assert any(f.key.startswith(want) for f in problems), [f.key for f in problems]

    def test_stale_baseline_entry_fails_like_jax(self, tmp_path):
        pkg = _pkg(tmp_path, "class Empty:\n    pass\n")
        p = tmp_path / "b.toml"
        p.write_text('[[suppress]]\nkey = "unlocked-write:gone"\n'
                     'justification = "was real once"\n'
                     'schedcheck_scenario = "-"\n')
        got = concurrency.check(pkg_dir=pkg, baseline_path=str(p))
        want = jax_concurrency.check(pkg_dir=pkg, baseline_path=str(p))
        assert [f.key for f in got] == [f.key for f in want] == ["baseline-stale:unlocked-write:gone"]
        assert [f.message for f in got] == [f.message for f in want]


# ---------------------------------------------------------------------------
# print ban
# ---------------------------------------------------------------------------

_PRINTS = '''
import sys

print("module level")


def cli():
    print("out")
    sys.stderr.write("err\\n")


class Daemon:
    def tick(self):
        print("narrative")
'''


class TestPrintBan:
    def test_port_tree_is_clean(self):
        assert printban.check() == []

    def test_scan_equals_jax_on_one_file(self, tmp_path):
        path = tmp_path / "mod.py"
        path.write_text(_PRINTS)
        got = printban._scan_file(str(path))
        assert got == jax_printban._scan_file(str(path))
        assert sorted(k.split(":", 1)[0] + ":" + k.rsplit(":", 1)[1] for k in got) == [
            "print:<module>", "print:cli", "print:tick", "stderr-write:cli"]

    @pytest.mark.parametrize("body,want", [
        ('[[suppress]]\nkey = "print:x:*"\njustification = "was a CLI"\n', "baseline-stale:"),
        ('[[suppress]]\nkey = "print:x:*"\n', "baseline-no-justification:"),
        ('[[suppress]]\nkey = print\n', "baseline-parse:"),
    ])
    def test_baseline_hygiene_equals_jax(self, tmp_path, monkeypatch, body, want):
        p = tmp_path / "printban.toml"
        p.write_text(body)
        for mod in (printban, jax_printban):
            monkeypatch.setattr(mod, "baseline_path", lambda: str(p))
            monkeypatch.setattr(mod, "collect", lambda: {})
        got = printban.check()
        assert [f.key for f in got] == [f.key for f in jax_printban.check()]
        assert any(f.key.startswith(want) for f in got), [f.key for f in got]

    def test_unlisted_print_is_a_finding(self, monkeypatch):
        hits = {"print:distlr_tpu_torch/serve/engine.py:score": [("x", 1)]}
        monkeypatch.setattr(printban, "collect", lambda: hits)
        keys = [f.key for f in printban.check()]
        assert list(hits)[0] in keys
        # every allowlist entry matches nothing now, so each reads as stale
        assert all(k.startswith("baseline-stale:") for k in keys if k not in hits)


# ---------------------------------------------------------------------------
# config / CLI / docs parity
# ---------------------------------------------------------------------------


def _columns(text):
    """Doc rows -> {field: [field, flag, default]} (the meaning column is
    each package's own comment text)."""
    import re
    return {m.group(1): m.group(0).split(" | ")[:3]
            for m in re.finditer(r"^\| `([a-z0-9_]+)` \|.*$", text, re.MULTILINE)}


class TestConfigDocLint:
    def test_port_tree_is_clean(self):
        assert config_doc.check() == []

    def test_doc_is_the_ports_and_current(self):
        assert config_doc.doc_path() == os.path.join(REPO, "distlr_tpu_torch", "CONFIG.md")
        with open(config_doc.doc_path()) as f:
            assert f.read() == config_doc.generate(), \
                "distlr_tpu_torch/CONFIG.md stale — run " \
                "`python -m distlr_tpu_torch.analysis --write-docs`"

    def test_rows_of_shared_fields_equal_jax(self):
        port, jax = _columns(config_doc.generate()), _columns(jax_config_doc.generate())
        shared = sorted(set(port) & set(jax))
        assert len(shared) >= 100
        assert {k: port[k] for k in shared} == {k: jax[k] for k in shared}
        # the port's own fields are documented with their flag
        assert port["device"] == ["| `device`", "`--device`", "`'cuda'`"]

    def test_audits_equal_jax_for_shared_fields(self):
        fields = config_doc.config_fields()
        assert config_doc.FLAG_ALIASES == jax_config_doc.FLAG_ALIASES
        assert set(config_doc.NO_FLAG) == {f for f in jax_config_doc.NO_FLAG if f in fields}

    def test_dropped_doc_row_fails_like_jax(self, tmp_path, monkeypatch):
        for mod, name in ((config_doc, "port"), (jax_config_doc, "jax")):
            text = mod.generate()
            doc = tmp_path / f"{name}.md"
            doc.write_text("\n".join(line for line in text.splitlines()
                                     if not line.startswith("| `prefetch` |")))
            monkeypatch.setattr(mod, "doc_path", lambda doc=doc: str(doc))
        got = [f.key for f in config_doc.check()]
        assert got == [f.key for f in jax_config_doc.check()] == ["undocumented-field:prefetch"]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


class TestRunner:
    def test_runner_exits_zero_on_port_tree(self, capsys, monkeypatch):
        from distlr_tpu_torch.analysis.fleetsim import lint as fleetsim_lint
        from distlr_tpu_torch.analysis.protocol import lint as protocol_lint
        from distlr_tpu_torch.analysis.schedcheck import lint as sched_lint

        called = []
        for name, mod in (("protocol", protocol_lint), ("sched", sched_lint),
                          ("fleetsim", fleetsim_lint)):
            monkeypatch.setattr(mod, "check", lambda name=name: called.append(name) or [])
        assert lint_main([]) == 0
        out = capsys.readouterr().out
        assert called == ["protocol", "sched", "fleetsim"]
        assert ("distlr-lint: clean (wire, concurrency, config, metrics, printban, "
                "protocol, sched, fleetsim)") in out
        assert "skipped" not in out

    def test_list_passes_lists_jaxs_eight(self, capsys):
        assert PASSES == JAX_PASSES
        assert lint_main(["--list-passes"]) == 0
        listed = [line.split(":", 1)[0] for line in capsys.readouterr().out.splitlines()]
        assert tuple(listed) == JAX_PASSES

    @pytest.mark.parametrize("name", ["fleetsim", "protocol"])
    def test_model_pass_runs_with_jax_findings(self, capsys, name):
        assert lint_main(["--only", name]) == 0
        assert f"distlr-lint: clean ({name})" in capsys.readouterr().out
        assert jax_run_pass(name) == []

    def test_single_pass_selection(self, capsys):
        assert lint_main(["--only", "wire"]) == 0
        out = capsys.readouterr().out
        assert "clean (wire)" in out and "skipped" not in out


# ---------------------------------------------------------------------------
# regression tests for the races the lints found
# ---------------------------------------------------------------------------


class _ProbeLock:
    """Context-manager lock stand-in recording acquisitions."""

    def __init__(self):
        self.acquired = 0

    def __enter__(self):
        self.acquired += 1
        return self

    def __exit__(self, *exc):
        return False


class _WriterOnRelease:
    """A lock whose release lets the worker in: leaving it mirrors the
    queued request (queue -1, mirrored +1), as the worker thread would
    the moment the lock is free."""

    def __init__(self, obj):
        self.obj = obj

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.obj._queue.clear()
        self.obj.mirrored += 1
        return False


class TestConcurrencyFixes:
    def test_membership_epoch_reads_under_lock(self):
        """The published epoch view takes the coordinator lock (resize
        commits it from another thread)."""
        from distlr_tpu_torch.ps.membership import MembershipCoordinator

        coord = MembershipCoordinator.__new__(MembershipCoordinator)
        coord._lock = _ProbeLock()
        coord._epoch = 7
        assert coord.epoch == 7
        assert coord._lock.acquired == 1

    def test_shadow_stats_is_one_snapshot(self):
        """``ShadowMirror.stats`` reads its counters under the lock that
        the worker and submit() move them under, with the queue length:
        a writer let in by the release cannot split the snapshot (the
        old body read the counters after leaving the lock)."""
        from distlr_tpu_torch.serve.tenant import ShadowMirror

        sm = ShadowMirror.__new__(ShadowMirror)
        sm._pairs, sm._queue = {}, [("t", "c", "1:1", [0.5])]
        sm.submitted, sm.mirrored, sm.dropped, sm.errors = 5, 3, 1, 0
        sm._lock = _WriterOnRelease(sm)
        st = sm.stats()
        assert (st["mirrored"], st["dropped"], st["errors"], st["queued"]) == (3, 1, 0, 1)
        # submitted = mirrored + dropped + errors + queued holds in the
        # snapshot (the old body gave 4 + 1 + 0 + 1)
        assert st["mirrored"] + st["dropped"] + st["errors"] + st["queued"] == sm.submitted

    def test_reloader_warns_only_under_its_poll_lock(self):
        """The degraded-poll warning reads and writes state that
        ``_poll_once`` guards, and runs only under ``_poll_lock`` (the
        ``_locked`` suffix says so to the lint): the port's only
        HotReloader findings are the monitoring reads of stats()."""
        from distlr_tpu_torch.serve.reload import HotReloader

        keys = [f.key for f in concurrency.shared_state_findings(concurrency.collect_classes())
                if ":HotReloader." in f.key]
        assert keys and all(k.startswith("unlocked-read:") and k.endswith(":stats") for k in keys)

        class _Failing:
            def poll(self):
                raise OSError("down")

        class _Engine:
            has_weights = False

        r = HotReloader(_Engine(), _Failing(), interval_s=1.0, jitter=0.0)
        held = []
        r._poll_lock = _ProbeLock()
        orig = r._warn_degraded_locked
        r._warn_degraded_locked = lambda what: (held.append(r._poll_lock.acquired), orig(what))
        assert r._poll_once() is False
        assert held == [1] and r.errors == 1 and r._degraded_since is not None

    def test_chaos_stop_reaps_storming_connections(self):
        """``ChaosLink.stop()`` joins the accept loop before it
        snapshots conns/threads under the lock, so after stop() returns
        under a connect storm, the accept thread and every pump thread
        are dead."""
        from distlr_tpu_torch.chaos.plan import FaultPlan
        from distlr_tpu_torch.chaos.proxy import ChaosFabric

        upstream = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        upstream.bind(("127.0.0.1", 0))
        upstream.listen(64)
        upstream.settimeout(0.1)
        up_conns: list[socket.socket] = []
        up_stop = threading.Event()

        def up_loop():
            while not up_stop.is_set():
                try:
                    c, _ = upstream.accept()
                    up_conns.append(c)
                except socket.timeout:
                    continue
                except OSError:
                    return

        up_thread = threading.Thread(target=up_loop, daemon=True)
        up_thread.start()
        port = upstream.getsockname()[1]
        try:
            for _round in range(3):
                fabric = ChaosFabric([("127.0.0.1", port)], FaultPlan(faults=()))
                link = fabric.links[0]
                storm_stop = threading.Event()

                def storm(link=link, storm_stop=storm_stop):
                    while not storm_stop.is_set():
                        try:
                            with socket.create_connection(("127.0.0.1", link.port),
                                                          timeout=0.5) as s:
                                s.sendall(b"x" * 8)
                        except OSError:
                            return

                stormers = [threading.Thread(target=storm, daemon=True) for _ in range(4)]
                for t in stormers:
                    t.start()
                time.sleep(0.05)
                fabric.stop()
                assert not link._accept_thread.is_alive()
                assert not any(t.is_alive() for t in link._threads), \
                    "pump thread leaked past stop()"
                storm_stop.set()
                for t in stormers:
                    t.join(timeout=5)
        finally:
            up_stop.set()
            try:
                upstream.close()
            except OSError:
                pass
            up_thread.join(timeout=5)
            for c in up_conns:
                try:
                    c.close()
                except OSError:
                    pass
