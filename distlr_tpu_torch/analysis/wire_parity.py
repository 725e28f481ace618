"""Wire-parity lint: the port's ``kv_protocol.h`` vs its Python protocol
mirrors (the port's copy of ``distlr_tpu/analysis/wire_parity.py``).

The bug class this kills is documented drift: wire constants
hand-mirrored from ``ps/native/kv_protocol.h`` into Python (kStats
length pins, hand-rolled copies of the reply framing) are each one edit
away from silently misframing the stream.
:mod:`distlr_tpu_torch.ps.wire` is THE Python mirror and every Python
framing site imports it; this pass enforces the whole arrangement
statically (no imports — the header and the mirrors are
parsed, so the lint runs even where torch/numpy/native toolchains don't):

* every protocol constant in the header has a :mod:`~distlr_tpu_torch.ps.wire`
  twin with the SAME value, and vice versa (one-sided constants fail
  with ``file:line`` on the side that has them);
* the ``static_assert``-ed frame sizes match the mirror's
  ``struct`` formats;
* ``STATS_FIELDS`` in :mod:`distlr_tpu_torch.ps.client` tracks
  ``kStatsVals``/``kStatsValsV1`` in length and v1 order;
* ``CODEC_IDS`` in :mod:`distlr_tpu_torch.compress.codecs` matches the
  header's ``Codec`` enum;
* no mirror site re-inlines a distinctive protocol value as a raw
  literal instead of naming it (the 4096 / 256 / magic class).
"""

from __future__ import annotations

import ast
import os
import re
import struct

from distlr_tpu_torch.analysis.report import Finding, rel, repo_root

#: header constant -> distlr_tpu_torch/ps/wire.py name.  ``sizeof(X)``
#: pseudo-constants come from the header's static_asserts.
HEADER_TO_WIRE = {
    "kMagic": "MAGIC",
    # enum class Op
    "kPush": "OP_PUSH",
    "kPull": "OP_PULL",
    "kBarrier": "OP_BARRIER",
    "kShutdown": "OP_SHUTDOWN",
    "kHello": "OP_HELLO",
    "kStats": "OP_STATS",
    "kPushPull": "OP_PUSH_PULL",
    "kEpoch": "OP_EPOCH",
    # enum Flags
    "kNone": "FLAG_NONE",
    "kResponse": "FLAG_RESPONSE",
    "kError": "FLAG_ERROR",
    "kInitPush": "FLAG_INIT_PUSH",
    "kForceInit": "FLAG_FORCE_INIT",
    "kCodecShift": "CODEC_SHIFT",
    "kCodecMask": "CODEC_MASK",
    "kOptState": "FLAG_OPT_STATE",
    "kTraced": "FLAG_TRACED",
    # enum Codec
    "kCodecNone": "CODEC_NONE",
    "kCodecInt8": "CODEC_INT8",
    "kCodecSign": "CODEC_SIGN",
    # constexpr values
    "kQuantBlock": "QUANT_BLOCK",
    "kStatsValsV1": "STATS_VALS_V1",
    "kStatsVals": "STATS_VALS",
    "kMaxValsPerKey": "MAX_VALS_PER_KEY",
    "kCapCodecInt8": "CAP_CODEC_INT8",
    "kCapCodecSign": "CAP_CODEC_SIGN",
    "kCapTrace": "CAP_TRACE",
    "kCapEpoch": "CAP_EPOCH",
    # static_assert-ed frame sizes
    "sizeof(MsgHeader)": "HEADER_SIZE",
    "sizeof(TraceFrame)": "TRACE_FRAME_SIZE",
}

#: wire.py integer constants with deliberately NO header twin, each with
#: the audit reason (the bidirectional check fails on unlisted extras)
WIRE_ONLY = {
    "AUX_MAX": "the u16 MsgHeader::aux width; the header types the "
               "field but names no constant for its ceiling",
}

#: header constant -> distlr_tpu_torch/ps/store.py name.  Disk formats drift
#: exactly like wire formats drift: the durable-store constants the
#: native writer stamps into snapshot/WAL files are mirrored in
#: ps/store.py (NOT wire.py — they never cross a socket) and the same
#: bidirectional parity applies.
HEADER_TO_STORE = {
    "kStoreMagic": "STORE_MAGIC",
    "kStoreVersion": "STORE_VERSION",
    "kStoreHeaderSize": "STORE_HEADER_SIZE",
    "kStoreGenerations": "STORE_GENERATIONS",
    "kStoreFlagFtrl": "STORE_FLAG_FTRL",
    "kStoreFlagInitialized": "STORE_FLAG_INITIALIZED",
    "kWalMagic": "WAL_MAGIC",
    "kWalHeaderSize": "WAL_HEADER_SIZE",
    "kWalRecordHeaderSize": "WAL_RECORD_HEADER_SIZE",
}

#: store.py struct format -> the header-size constant it must pack to
STORE_STRUCT_SIZES = (
    ("SNAP_HEADER_STRUCT", "STORE_HEADER_SIZE"),
    ("WAL_SEGMENT_STRUCT", "WAL_HEADER_SIZE"),
    ("WAL_RECORD_STRUCT", "WAL_RECORD_HEADER_SIZE"),
)

#: the v1 kStats counter order the protocol comment fixes (the client's
#: STATS_FIELDS prefix must reproduce it exactly)
STATS_V1_ORDER = ("dim", "initialized", "pending_sync_pushes",
                  "barrier_waiters", "total_pushes", "total_pulls")

#: Python files that mirror wire framing (repo-relative) — the raw-
#: literal scan targets.  wire.py itself is the definition site.  The
#: protocol MODEL (analysis/protocol/) is a framing site like any other:
#: its op/flag/capability identities must come from wire.py, so the
#: executable spec can never drift from the header it verifies.
MIRROR_SITES = (
    "distlr_tpu_torch/ps/client.py",
    "distlr_tpu_torch/ps/membership.py",
    "distlr_tpu_torch/ps/server.py",
    "distlr_tpu_torch/compress/codecs.py",
    "distlr_tpu_torch/chaos/proxy.py",
    "distlr_tpu_torch/analysis/protocol/spec.py",
    "distlr_tpu_torch/analysis/protocol/checker.py",
    "distlr_tpu_torch/analysis/protocol/mutants.py",
    "distlr_tpu_torch/analysis/protocol/conformance.py",
)

#: distinctive protocol values that must never appear as bare literals
#: in a mirror site (small ints like op codes and flag bits are too
#: collision-prone to scan for; these are unmistakable).  The store/WAL
#: magics are disk-format constants — named through ps/store.py.
_DISTINCTIVE = ("kMagic", "kQuantBlock", "kMaxValsPerKey",
                "kStoreMagic", "kWalMagic")


def header_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "ps", "native",
                        "kv_protocol.h")


def wire_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "ps", "wire.py")


# ---------------------------------------------------------------------------
# C header parsing
# ---------------------------------------------------------------------------

_INT_SUFFIX = re.compile(r"(?<=[0-9a-fA-Fx])(?:[uU]?[lL]{0,2}|[uU]?[lL][lL]?)\b")
_CONSTEXPR = re.compile(
    r"^\s*constexpr\s+[A-Za-z_][A-Za-z0-9_]*\s+(k[A-Za-z0-9_]+)\s*=\s*([^;]+);")
_ENUM_START = re.compile(r"^\s*enum\s+(class\s+)?([A-Za-z_]+)")
_ENUM_ENTRY = re.compile(r"^\s*(k[A-Za-z0-9_]+)\s*=\s*([^,}]+)\s*[,}]?")
_STATIC_ASSERT = re.compile(
    r"static_assert\s*\(\s*sizeof\s*\(\s*([A-Za-z_]+)\s*\)\s*==\s*(\d+)")


def _eval_cxx(expr: str, env: dict[str, int]) -> int:
    """Evaluate a C++ integer constant expression (literals with
    u/l suffixes, shifts, or-ed masks, references to earlier constants)
    using Python's own parser on the sanitized text."""
    text = _INT_SUFFIX.sub("", expr.strip())
    node = ast.parse(text, mode="eval").body
    return _eval_node(node, env, {})


def parse_header(path: str | None = None) -> dict[str, tuple[int, int]]:
    """Every protocol constant in the header -> ``(value, line)``:
    ``constexpr`` values, all enum entries, and the ``static_assert``-ed
    ``sizeof(Type)`` frame sizes (keyed ``"sizeof(Type)"``)."""
    path = path or header_path()
    out: dict[str, tuple[int, int]] = {}
    env: dict[str, int] = {}
    in_enum = False
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines, start=1):
        # strip // comments (the header is richly commented; a constant
        # mentioned in prose must not parse as a definition)
        code = line.split("//", 1)[0]
        if not code.strip():
            continue
        m = _STATIC_ASSERT.search(code)
        if m:
            out[f"sizeof({m.group(1)})"] = (int(m.group(2)), i)
            continue
        m = _CONSTEXPR.match(code)
        if m:
            try:
                val = _eval_cxx(m.group(2), env)
            except (ValueError, SyntaxError, KeyError):
                continue
            out[m.group(1)] = (val, i)
            env[m.group(1)] = val
            continue
        if _ENUM_START.match(code):
            in_enum = True
        if in_enum:
            m = _ENUM_ENTRY.match(code)
            if m:
                try:
                    val = _eval_cxx(m.group(2), env)
                except (ValueError, SyntaxError, KeyError):
                    continue
                out[m.group(1)] = (val, i)
                env[m.group(1)] = val
            if "}" in code:
                in_enum = False
    return out


# ---------------------------------------------------------------------------
# Python mirror parsing (static — modules are never imported)
# ---------------------------------------------------------------------------


def _eval_node(node: ast.AST, env: dict, modules: dict[str, dict]) -> int:
    """Tiny constant evaluator for mirror modules: int literals, binary
    arithmetic, names bound earlier in the module, and ``mod.NAME``
    attributes of an already-parsed mirror module."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, str)):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id in modules
            and node.attr in modules[node.value.id]):
        return modules[node.value.id][node.attr]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_node(node.operand, env, modules)
    if isinstance(node, ast.BinOp):
        lhs = _eval_node(node.left, env, modules)
        rhs = _eval_node(node.right, env, modules)
        ops = {ast.LShift: lambda a, b: a << b,
               ast.RShift: lambda a, b: a >> b,
               ast.BitOr: lambda a, b: a | b,
               ast.BitAnd: lambda a, b: a & b,
               ast.Add: lambda a, b: a + b,
               ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b,
               ast.FloorDiv: lambda a, b: a // b}
        fn = ops.get(type(node.op))
        if fn is None:
            raise ValueError(f"unsupported operator {ast.dump(node.op)}")
        return fn(lhs, rhs)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "Struct" and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)):
        # struct.Struct("<fmt>") -> its wire size (what parity cares about)
        return struct.calcsize(node.args[0].value)
    raise ValueError(f"unsupported expression {ast.dump(node)}")


def module_constants(path: str,
                     modules: dict[str, dict] | None = None
                     ) -> dict[str, tuple[object, int]]:
    """Module-level ``NAME = <const expr>`` bindings -> ``(value,
    line)``, resolved statically.  Tuples and dicts of constants are
    kept whole (STATS_FIELDS, CODEC_IDS); unevaluable assignments are
    skipped."""
    modules = modules or {}
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out: dict[str, tuple[object, int]] = {}
    env: dict[str, object] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        try:
            if isinstance(node.value, (ast.Tuple, ast.List)):
                val: object = tuple(_eval_node(el, env, modules)
                                    for el in node.value.elts)
            elif isinstance(node.value, ast.Dict):
                val = {_eval_node(k, env, modules):
                       _eval_node(v, env, modules)
                       for k, v in zip(node.value.keys, node.value.values)}
            else:
                val = _eval_node(node.value, env, modules)
        except (ValueError, KeyError, struct.error):
            continue
        out[tgt.id] = (val, node.lineno)
        env[tgt.id] = val
    return out


def _import_aliases(path: str, target_module: str) -> set[str]:
    """Local names under which ``target_module`` is visible in a file
    (``from distlr_tpu_torch.ps import wire`` -> {"wire"})."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names: set[str] = set()
    short = target_module.rsplit(".", 1)[-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == target_module:
                    names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if f"{mod}.{a.name}" == target_module or (
                        mod == target_module.rsplit(".", 1)[0]
                        and a.name == short):
                    names.add(a.asname or a.name)
    return names


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def check(root: str | None = None,
          header: str | None = None) -> list[Finding]:
    """Run the wire-parity pass; returns findings ([] = parity holds).

    ``root``/``header`` exist for the self-test fixtures: the pass can
    be pointed at a seeded tree to prove it actually fails on a
    mismatch.
    """
    root = root or repo_root()
    hpath = header or os.path.join(root, "distlr_tpu_torch", "ps", "native",
                                   "kv_protocol.h")
    wpath = os.path.join(root, "distlr_tpu_torch", "ps", "wire.py")
    findings: list[Finding] = []
    hdr = parse_header(hpath)
    wire_vals = module_constants(wpath)
    hrel, wrel = rel(hpath) if root == repo_root() else hpath, \
        rel(wpath) if root == repo_root() else wpath

    # direction 1: every header constant has a wire twin of equal value
    # (durable-store constants route to ps/store.py — see
    # _check_store_format — and are skipped here)
    for hname, (hval, hline) in sorted(hdr.items()):
        if hname in HEADER_TO_STORE:
            continue
        wname = HEADER_TO_WIRE.get(hname)
        if wname is None:
            findings.append(Finding(
                "wire", f"header-only:{hname}",
                f"{hname} = {hval} exists in the header but has no "
                "distlr_tpu_torch/ps/wire.py mirror (add it and extend "
                "HEADER_TO_WIRE)",
                ((hrel, hline),)))
            continue
        if wname not in wire_vals:
            findings.append(Finding(
                "wire", f"missing-mirror:{wname}",
                f"header {hname} = {hval} should mirror as wire.{wname}, "
                "which does not exist",
                ((hrel, hline), (wrel, 1))))
            continue
        wval, wline = wire_vals[wname]
        if wval != hval:
            findings.append(Finding(
                "wire", f"value-mismatch:{hname}",
                f"{hname} = {hval} in the header but wire.{wname} = "
                f"{wval} — the mirrors drifted",
                ((hrel, hline), (wrel, wline))))

    # direction 2: every wire int constant is either a mirror or audited
    mirrored = set(HEADER_TO_WIRE.values())
    for wname, (wval, wline) in sorted(wire_vals.items()):
        if not isinstance(wval, int) or wname.startswith("_"):
            continue
        if wname.endswith("_STRUCT"):
            continue  # struct objects; covered by the struct-size check
        if wname in mirrored or wname in WIRE_ONLY:
            continue
        findings.append(Finding(
            "wire", f"wire-only:{wname}",
            f"wire.{wname} = {wval} has no header twin and no WIRE_ONLY "
            "audit entry — either the header lost a constant or this "
            "needs an audited justification",
            ((wrel, wline),)))

    # struct formats must match the static_assert-ed sizes
    for sname, fname in (("HEADER_STRUCT", "HEADER_SIZE"),
                         ("TRACE_FRAME_STRUCT", "TRACE_FRAME_SIZE")):
        if sname in wire_vals and fname in wire_vals:
            sval, sline = wire_vals[sname]
            if sval != wire_vals[fname][0]:
                findings.append(Finding(
                    "wire", f"struct-size:{sname}",
                    f"wire.{sname} packs {sval} bytes but "
                    f"{fname} = {wire_vals[fname][0]}",
                    ((wrel, sline),)))

    findings += _check_store_format(root, hdr, hrel)
    findings += _check_stats_fields(root, hdr, hrel)
    findings += _check_codec_ids(root, hdr, hrel)
    findings += _check_raw_literals(root, hdr, hrel)
    return findings


def _check_store_format(root: str, hdr: dict, hrel: str) -> list[Finding]:
    """ps/store.py must mirror the header's durable-store constants
    exactly, in both directions, and its struct formats must pack to
    the header's pinned sizes — a disk-format edit that touches only
    one side fails the lint before it can strand snapshots."""
    spath = os.path.join(root, "distlr_tpu_torch", "ps", "store.py")
    srel = rel(spath) if root == repo_root() else spath
    if not os.path.exists(spath):
        if any(h in hdr for h in HEADER_TO_STORE):
            return [Finding(
                "wire", "store-mirror-missing",
                "the header defines durable-store constants but "
                "distlr_tpu_torch/ps/store.py does not exist", ((hrel, 1),))]
        return []
    store_vals = module_constants(spath)
    out: list[Finding] = []

    # direction 1: every header store constant has a store.py twin
    for hname, sname in sorted(HEADER_TO_STORE.items()):
        if hname not in hdr:
            out.append(Finding(
                "wire", f"store-header-lost:{hname}",
                f"HEADER_TO_STORE maps {hname} but the header no longer "
                "defines it", ((hrel, 1),)))
            continue
        hval, hline = hdr[hname]
        if sname not in store_vals:
            out.append(Finding(
                "wire", f"store-missing-mirror:{sname}",
                f"header {hname} = {hval} should mirror as "
                f"store.{sname}, which does not exist",
                ((hrel, hline), (srel, 1))))
            continue
        sval, sline = store_vals[sname]
        if sval != hval:
            out.append(Finding(
                "wire", f"store-value-mismatch:{hname}",
                f"{hname} = {hval} in the header but store.{sname} = "
                f"{sval} — the disk-format mirrors drifted",
                ((hrel, hline), (srel, sline))))

    # direction 2: every store.py int constant is a mirror (no
    # unaudited disk-format constants on the Python side)
    mirrored = set(HEADER_TO_STORE.values())
    for sname, (sval, sline) in sorted(store_vals.items()):
        if not isinstance(sval, int) or sname.startswith("_"):
            continue
        if sname.endswith("_STRUCT"):
            continue  # struct objects; covered by the size check below
        if sname in mirrored:
            continue
        out.append(Finding(
            "wire", f"store-only:{sname}",
            f"store.{sname} = {sval} has no kv_protocol.h twin — either "
            "the header lost a durable-store constant or HEADER_TO_STORE "
            "needs the new mapping", ((srel, sline),)))

    # struct formats must pack to the header-pinned sizes
    for stname, szname in STORE_STRUCT_SIZES:
        if stname in store_vals and szname in store_vals:
            stval, stline = store_vals[stname]
            if stval != store_vals[szname][0]:
                out.append(Finding(
                    "wire", f"store-struct-size:{stname}",
                    f"store.{stname} packs {stval} bytes but "
                    f"{szname} = {store_vals[szname][0]}",
                    ((srel, stline),)))
    return out


def _check_stats_fields(root: str, hdr: dict, hrel: str) -> list[Finding]:
    """STATS_FIELDS in ps/client.py must track kStatsVals in length and
    reproduce the protocol's v1 counter order as its prefix."""
    cpath = os.path.join(root, "distlr_tpu_torch", "ps", "client.py")
    if not os.path.exists(cpath):
        return []
    crel = rel(cpath) if root == repo_root() else cpath
    consts = module_constants(cpath)
    out: list[Finding] = []
    if "STATS_FIELDS" not in consts:
        return [Finding("wire", "stats-fields-missing",
                        "ps/client.py no longer defines a statically "
                        "readable STATS_FIELDS tuple", ((crel, 1),))]
    fields, line = consts["STATS_FIELDS"]
    n_hdr, hline = hdr.get("kStatsVals", (None, 1))
    v1_hdr, v1line = hdr.get("kStatsValsV1", (None, 1))
    if n_hdr is not None and len(fields) != n_hdr:
        out.append(Finding(
            "wire", "stats-fields-length",
            f"STATS_FIELDS names {len(fields)} counters but the header "
            f"pins kStatsVals = {n_hdr} — extend BOTH sides together",
            ((crel, line), (hrel, hline))))
    if v1_hdr is not None and fields[:v1_hdr] != STATS_V1_ORDER[:v1_hdr]:
        out.append(Finding(
            "wire", "stats-fields-v1-order",
            f"STATS_FIELDS v1 prefix {fields[:v1_hdr]} != the protocol "
            f"order {STATS_V1_ORDER[:v1_hdr]} (kStatsValsV1 = {v1_hdr}; "
            "old servers reply exactly these, in exactly this order)",
            ((crel, line), (hrel, v1line))))
    return out


def _check_codec_ids(root: str, hdr: dict, hrel: str) -> list[Finding]:
    """CODEC_IDS in compress/codecs.py must match the Codec enum."""
    cpath = os.path.join(root, "distlr_tpu_torch", "compress", "codecs.py")
    if not os.path.exists(cpath):
        return []
    crel = rel(cpath) if root == repo_root() else cpath
    wpath = os.path.join(root, "distlr_tpu_torch", "ps", "wire.py")
    wire_env = {n: v for n, (v, _ln) in module_constants(wpath).items()
                if isinstance(v, int)}
    aliases = _import_aliases(cpath, "distlr_tpu_torch.ps.wire")
    consts = module_constants(cpath, {a: wire_env for a in aliases})
    if "CODEC_IDS" not in consts:
        return [Finding("wire", "codec-ids-missing",
                        "compress/codecs.py no longer defines a "
                        "statically readable CODEC_IDS dict",
                        ((crel, 1),))]
    ids, line = consts["CODEC_IDS"]
    expected = {"none": hdr.get("kCodecNone", (0, 0))[0],
                "int8": hdr.get("kCodecInt8", (1, 0))[0],
                "signsgd": hdr.get("kCodecSign", (2, 0))[0]}
    if ids != expected:
        return [Finding(
            "wire", "codec-ids-mismatch",
            f"CODEC_IDS = {ids} but the header's Codec enum says "
            f"{expected}", ((crel, line), (hrel, 1)))]
    return []


def _check_raw_literals(root: str, hdr: dict, hrel: str) -> list[Finding]:
    """No mirror site may re-inline a distinctive protocol value as a
    bare literal — name it through distlr_tpu_torch.ps.wire instead."""
    distinctive = {hdr[n][0]: n for n in _DISTINCTIVE if n in hdr}
    out: list[Finding] = []
    for site in MIRROR_SITES:
        path = os.path.join(root, site)
        if not os.path.exists(path):
            continue
        srel = rel(path) if root == repo_root() else path
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, int)
                    and not isinstance(node.value, bool)
                    and node.value in distinctive):
                cname = distinctive[node.value]
                if cname in HEADER_TO_STORE:
                    named = f"store.{HEADER_TO_STORE[cname]}"
                else:
                    named = f"wire.{HEADER_TO_WIRE.get(cname, '?')}"
                out.append(Finding(
                    "wire",
                    f"raw-literal:{site}:{cname}",
                    f"protocol value {node.value} ({cname}) appears as "
                    f"a raw literal — use the named "
                    f"{named} mirror",
                    ((srel, node.lineno), (hrel, hdr[cname][1]))))
    return out
