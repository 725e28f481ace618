"""Concurrency lint: shared-state discipline + lock-order cycles (the
port's copy of ``distlr_tpu/analysis/concurrency.py``).

The fleet's history is a catalog of races that only human eyes caught
(the barrier double-vote, a probe's read-modify-write, the joiner's
spool/pending races) — and in a
Hogwild-style system some races are INTENTIONAL, which is exactly why
the accidental ones must be machine-distinguishable.  Two AST passes
over ``distlr_tpu_torch/`` (static — nothing is imported):

**Shared-state registry.**  For every class that provably crosses
threads (spawns ``threading.Thread``, subclasses ``Thread`` or a
``socketserver`` server, or owns a lock — owning a lock is a
self-declaration of cross-thread sharing), find attributes written
under a ``with self.<lock>:`` in one method but read or written
lock-free in another.  ``__init__`` is exempt (construction
happens-before thread start).

**Lock-order graph.**  Every lock the package creates is a node; an
edge ``A -> B`` means some code path acquires B while holding A —
through direct ``with`` nesting, same-class method calls (one level of
closure), or calls through attributes whose class is statically known
(``self.group = ServerGroup(...)`` or an annotated ctor parameter).  A
cycle in this graph is a deadlock waiting for the right interleaving.

Intentional findings live in ``analysis/concurrency_baseline.toml``;
every entry REQUIRES a one-line justification, and a finding not in the
baseline fails the build.  Stale baseline entries (matching nothing)
fail too — suppressions must never outlive their race.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from distlr_tpu_torch.analysis.report import Finding, repo_root

#: names that create a lock when assigned to an attribute / module global
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
#: base-class names marking a class as thread-crossing by construction
_THREADED_BASES = {"Thread", "ThreadingTCPServer", "ThreadingMixIn",
                   "StreamRequestHandler", "BaseRequestHandler"}


@dataclasses.dataclass
class Access:
    attr: str
    line: int
    held: frozenset[str]  # lock attrs held at this point
    kind: str             # "read" | "write"


@dataclasses.dataclass
class MethodInfo:
    name: str
    line: int
    accesses: list[Access] = dataclasses.field(default_factory=list)
    #: (lock_node, line, locks_held_at_acquire)
    acquires: list[tuple[str, int, frozenset[str]]] = \
        dataclasses.field(default_factory=list)
    #: same-class methods this one calls: (name, line, held)
    self_calls: list[tuple[str, int, frozenset[str]]] = \
        dataclasses.field(default_factory=list)
    #: calls through typed attributes: (attr, method, line, held)
    attr_calls: list[tuple[str, str, int, frozenset[str]]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    module: str   # repo-relative path
    name: str
    line: int
    lock_attrs: dict[str, int] = dataclasses.field(default_factory=dict)
    spawns_threads: bool = False
    threaded_base: bool = False
    methods: dict[str, MethodInfo] = dataclasses.field(default_factory=dict)
    #: self.<attr> -> class NAME it holds (ctor construction or
    #: annotated ctor param)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def crosses_threads(self) -> bool:
        return bool(self.spawns_threads or self.threaded_base
                    or self.lock_attrs)


def _iter_py(pkg_dir: str):
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _is_lock_factory(node: ast.AST) -> bool:
    """``threading.Lock()`` / ``Lock()`` / ``threading.RLock()`` ..."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _LOCK_FACTORIES
    if isinstance(fn, ast.Name):
        return fn.id in _LOCK_FACTORIES
    return False


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _MethodVisitor(ast.NodeVisitor):
    """Walk one method body tracking the set of self-locks held."""

    def __init__(self, info: MethodInfo, lock_attrs: set[str]):
        self.info = info
        self.locks = lock_attrs
        self.held: list[str] = []

    def _frozen(self) -> frozenset[str]:
        return frozenset(self.held)

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.locks:
                self.info.acquires.append(
                    (attr, node.lineno, self._frozen()))
                acquired.append(attr)
                self.held.append(attr)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr not in self.locks:
            kind = ("write" if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read")
            self.info.accesses.append(
                Access(attr, node.lineno, self._frozen(), kind))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        # self.x += 1 parses the target as a Load-ctx read in some
        # branches; record the read-modify-write explicitly as a write
        attr = _self_attr(node.target)
        if attr is not None and attr not in self.locks:
            self.info.accesses.append(
                Access(attr, node.lineno, self._frozen(), "write"))
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # self.m(...)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                self.info.self_calls.append(
                    (fn.attr, node.lineno, self._frozen()))
            # self.attr.m(...)
            inner = _self_attr(fn.value)
            if inner is not None:
                self.info.attr_calls.append(
                    (inner, fn.attr, node.lineno, self._frozen()))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested closures (thread bodies defined inline) run on OTHER
        # threads: whatever locks the spawner holds are NOT held there
        saved, self.held = self.held, []
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef


def _collect_class(cls_node: ast.ClassDef, module: str) -> ClassInfo:
    info = ClassInfo(module=module, name=cls_node.name, line=cls_node.lineno)
    for base in cls_node.bases:
        name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else "")
        if name in _THREADED_BASES:
            info.threaded_base = True
    # pass 1: lock attrs + attribute types from every method (locks are
    # overwhelmingly bound in __init__, but start()/reset styles exist)
    for item in cls_node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        ann: dict[str, str] = {}
        for arg in item.args.args + item.args.kwonlyargs:
            a = arg.annotation
            if isinstance(a, ast.Name):
                ann[arg.arg] = a.id
            elif (isinstance(a, ast.Constant) and isinstance(a.value, str)):
                ann[arg.arg] = a.value.strip('"').split(".")[-1]
        for node in ast.walk(item):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                attr = _self_attr(node.targets[0])
                if attr is None:
                    continue
                if _is_lock_factory(node.value):
                    info.lock_attrs.setdefault(attr, node.lineno)
                elif (isinstance(node.value, ast.Call)
                      and isinstance(node.value.func, ast.Name)):
                    info.attr_types.setdefault(attr, node.value.func.id)
                elif (isinstance(node.value, ast.Name)
                      and node.value.id in ann):
                    info.attr_types.setdefault(attr, ann[node.value.id])
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Thread"):
                info.spawns_threads = True
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Thread"):
                info.spawns_threads = True
    # pass 2: per-method access/acquire walk
    locks = set(info.lock_attrs)
    for item in cls_node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        m = MethodInfo(name=item.name, line=item.lineno)
        v = _MethodVisitor(m, locks)
        if item.name.endswith("_locked"):
            # repo convention: a *_locked method asserts its caller
            # already holds the class lock — its accesses are guarded,
            # and flagging them would punish exactly the discipline the
            # lint wants to encourage
            v.held.append("<caller-held>")
        for stmt in item.body:
            v.visit(stmt)
        info.methods[item.name] = m
    return info


def collect_classes(pkg_dir: str | None = None) -> list[ClassInfo]:
    pkg_dir = pkg_dir or os.path.join(repo_root(), "distlr_tpu_torch")
    root = os.path.dirname(pkg_dir)
    out: list[ClassInfo] = []
    for path in _iter_py(pkg_dir):
        with open(path) as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        module = os.path.relpath(path, root)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                out.append(_collect_class(node, module))
    return out


# ---------------------------------------------------------------------------
# finding generators
# ---------------------------------------------------------------------------


def shared_state_findings(classes: list[ClassInfo]) -> list[Finding]:
    """Attributes written under a lock in one method but accessed
    lock-free in another, on thread-crossing classes."""
    out: list[Finding] = []
    for cls in classes:
        if not cls.crosses_threads or not cls.lock_attrs:
            continue
        guarded: dict[str, tuple[str, int]] = {}  # attr -> (method, line)
        for m in cls.methods.values():
            if m.name == "__init__":
                continue
            for a in m.accesses:
                if a.kind == "write" and a.held and a.attr not in guarded:
                    guarded[a.attr] = (m.name, a.line)
        for attr, (gm, gline) in sorted(guarded.items()):
            for m in cls.methods.values():
                if m.name == "__init__":
                    continue
                bare = [a for a in m.accesses
                        if a.attr == attr and not a.held]
                if not bare:
                    continue
                kind = ("write" if any(a.kind == "write" for a in bare)
                        else "read")
                a0 = min(bare, key=lambda a: a.line)
                out.append(Finding(
                    "concurrency",
                    f"unlocked-{kind}:{cls.module}:{cls.name}.{attr}"
                    f":{m.name}",
                    f"{cls.name}.{attr} is written under a lock in "
                    f"{gm}() but {kind.replace('write', 'written')}"
                    f"{'' if kind == 'write' else ''} lock-free in "
                    f"{m.name}() — either take the lock, or baseline it "
                    "with a justification if the race is intentional",
                    ((cls.module, a0.line), (cls.module, gline))))
    # dedupe: one finding per (class, attr, method, kind)
    seen: set[str] = set()
    uniq = []
    for f in out:
        if f.key not in seen:
            seen.add(f.key)
            uniq.append(f)
    return uniq


def _acquired_closure(cls: ClassInfo) -> dict[str, set[tuple[str, int]]]:
    """Per method: self-locks it may acquire, directly or through ONE
    level of same-class calls -> {(lock_attr, line)}."""
    direct: dict[str, set[tuple[str, int]]] = {}
    for name, m in cls.methods.items():
        direct[name] = {(lk, ln) for lk, ln, _held in m.acquires}
    closed: dict[str, set[tuple[str, int]]] = {}
    for name, m in cls.methods.items():
        s = set(direct[name])
        for callee, ln, _held in m.self_calls:
            for lk, _ln2 in direct.get(callee, ()):
                s.add((lk, ln))
        closed[name] = s
    return closed


def lock_order_findings(classes: list[ClassInfo]) -> list[Finding]:
    """Build the cross-module lock-acquisition-order graph and report
    every cycle (a deadlock needs only the right interleaving)."""
    by_name = {c.name: c for c in classes}
    #: per-class acquisition closures, memoized — the typed-attribute
    #: branch below needs the TARGET class's closure per call site, and
    #: recomputing it there was O(call sites x methods)
    closures = {c.name: _acquired_closure(c) for c in classes}
    #: edge (holder_node, acquired_node) -> (module, line)
    edges: dict[tuple[str, str], tuple[str, int]] = {}

    def node(cls: ClassInfo, attr: str) -> str:
        return f"{cls.name}.{attr}"

    for cls in classes:
        closure = closures[cls.name]
        for m in cls.methods.values():
            # direct nesting + nested-through-self-calls; the
            # "<caller-held>" pseudo-token of *_locked methods never
            # names a real lock and takes no part in the order graph
            for lk, ln, held in m.acquires:
                for h in held:
                    if h.startswith("<"):
                        continue
                    edges.setdefault((node(cls, h), node(cls, lk)),
                                     (cls.module, ln))
            for callee, ln, held in m.self_calls:
                if not held:
                    continue
                for lk, _ln2 in closure.get(callee, ()):
                    for h in held:
                        if lk != h and not h.startswith("<"):
                            edges.setdefault(
                                (node(cls, h), node(cls, lk)),
                                (cls.module, ln))
            # calls through statically-typed attributes
            for attr, meth, ln, held in m.attr_calls:
                if not held:
                    continue
                tgt = by_name.get(cls.attr_types.get(attr, ""))
                if tgt is None:
                    continue
                for lk, _ln2 in closures[tgt.name].get(meth, ()):
                    for h in held:
                        if h.startswith("<"):
                            continue
                        edges.setdefault(
                            (node(cls, h), node(tgt, lk)),
                            (cls.module, ln))

    # cycle detection (DFS, reporting each strongly-connected loop once)
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    out: list[Finding] = []
    reported: set[frozenset[str]] = set()

    def dfs(start: str, cur: str, path: list[str]) -> None:
        for nxt in sorted(graph.get(cur, ())):
            if nxt == start and len(path) > 1:
                key = frozenset(path)
                if key in reported:
                    continue
                reported.add(key)
                cycle = path + [start]
                locs = tuple(
                    edges[(cycle[i], cycle[i + 1])]
                    for i in range(len(cycle) - 1)
                    if (cycle[i], cycle[i + 1]) in edges)
                out.append(Finding(
                    "concurrency",
                    "lock-cycle:" + "->".join(sorted(path)),
                    "lock-acquisition-order cycle "
                    + " -> ".join(cycle)
                    + " — two threads entering from different ends "
                    "deadlock; impose a global order or baseline with "
                    "a justification",
                    locs))
            elif nxt not in path and nxt > start:
                # only walk nodes > start so each cycle is found from
                # its smallest node exactly once
                dfs(start, nxt, path + [nxt])

    for n in sorted(graph):
        dfs(n, n, [n])
    return out


def check(pkg_dir: str | None = None,
          baseline_path: str | None = None) -> list[Finding]:
    """Run both concurrency passes, apply the audited baseline, and
    return the unsuppressed findings plus any baseline hygiene problems
    (missing justification, stale entry)."""
    from distlr_tpu_torch.analysis.baseline import (
        apply_baseline,
        load_baseline,
        scenario_crossref,
    )

    classes = collect_classes(pkg_dir)
    findings = shared_state_findings(classes) + lock_order_findings(classes)
    entries, problems = load_baseline(baseline_path)
    kept, stale = apply_baseline(findings, entries)
    for f in stale:
        kept.append(f)
    return kept + problems + scenario_crossref(entries)
