"""Build and locate the port's native PS components: the KV server binary
and the ctypes client library, standard or under a sanitizer.

The port's own copies of ``kv_server.cc``, ``kv_client.cc`` and
``kv_protocol.h`` (``ps/native/``) are compiled with ``g++`` and the JAX
package's standard flags (``distlr_tpu/ps/native/Makefile``) into
``build/native/`` at the root of the checkout, each under a name hashed
from its source, the protocol header and the flags, behind a file lock
of its own (:mod:`distlr_tpu_torch.utils.native`).

**Sanitizer matrix** (``DISTLR_NATIVE_VARIANT={tsan,asan,ubsan}``): the
same sources build instrumented twins with the JAX package's ``SANFLAGS``
and ``-fsanitize=...``, each its own hashed artifact, and setting the
variable makes this module hand them out, so every ``ServerGroup`` spawn
(the start, a supervisor's respawn, a resize's spawns) and, for ``tsan``,
the ctypes client run instrumented with no change at any call site:

* ``tsan``: the TSan server binary and the TSan client library.  Loading
  an instrumented ``.so`` into an uninstrumented Python needs the TSan
  runtime preloaded (``LD_PRELOAD=$(g++ -print-file-name=libtsan.so)``);
  :func:`client_lib` fails with exactly that instruction without it.
* ``asan`` / ``ubsan``: instrumented server binaries; the client stays
  standard (the ASan runtime cannot be loaded into an uninstrumented
  process by ``dlopen``).

The checked-in suppression files (``ps/native/*.supp``, byte-equal to
the JAX package's and empty of entries) reach every spawned server
through :func:`sanitizer_environ`, so any report fails the run until it
is fixed or audited there.

``python -m distlr_tpu_torch.ps.build sanitizers`` builds the whole
matrix ahead of time (the JAX package's ``make sanitizers``).
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from distlr_tpu_torch.utils import native

NATIVE_DIR = Path(__file__).resolve().parent / "native"
HEADER = NATIVE_DIR / "kv_protocol.h"
SERVER_SOURCE = NATIVE_DIR / "kv_server.cc"
CLIENT_SOURCE = NATIVE_DIR / "kv_client.cc"

#: the JAX package's ``SANFLAGS`` (``distlr_tpu/ps/native/Makefile``)
SANITIZER_FLAGS = ("-std=c++17", "-O1", "-g", "-fno-omit-frame-pointer", "-Wall", "-Wextra",
                   "-pthread")
#: sanitizer variant -> (artifact suffix, options variable, compiler flags)
_VARIANTS = {
    "tsan": ("_tsan", "TSAN_OPTIONS", ("-fsanitize=thread",)),
    "asan": ("_asan", "ASAN_OPTIONS", ("-fsanitize=address",)),
    "ubsan": ("_ubsan", "UBSAN_OPTIONS", ("-fsanitize=undefined", "-fno-sanitize-recover=all")),
}
VARIANTS = tuple(_VARIANTS)


def native_variant() -> str:
    """The active sanitizer variant ("" = the standard build)."""
    v = os.environ.get("DISTLR_NATIVE_VARIANT", "").strip().lower()
    if v in ("", "none"):
        return ""
    if v not in _VARIANTS:
        raise ValueError(
            f"DISTLR_NATIVE_VARIANT must be one of {tuple(_VARIANTS)} "
            f"(or unset), got {v!r}")
    return v


def _variant(variant: str | None) -> str:
    """``variant`` checked, or the active one when None."""
    if variant is None:
        return native_variant()
    if variant and variant not in _VARIANTS:
        raise ValueError(f"unknown sanitizer variant {variant!r}: one of {VARIANTS} or ''")
    return variant


def server_binary(variant: str | None = None) -> Path:
    """Build (once) and return the KV server executable of ``variant``
    (default: the active one, :func:`native_variant`)."""
    v = _variant(variant)
    if not v:
        return native.build("distlr_torch_kv_server", [SERVER_SOURCE, HEADER], shared=False)
    suffix, _, flags = _VARIANTS[v]
    return native.build(f"distlr_torch_kv_server{suffix}", [SERVER_SOURCE, HEADER],
                        shared=False, flags=SANITIZER_FLAGS + flags)


def _tsan_runtime_preloaded() -> bool:
    return "libtsan" in os.environ.get("LD_PRELOAD", "")


def _standard_client() -> Path:
    return native.build("libdistlr_torch_kv", [CLIENT_SOURCE, HEADER], shared=True)


def _tsan_client() -> Path:
    return native.build("libdistlr_torch_kv_tsan", [CLIENT_SOURCE, HEADER], shared=True,
                        flags=SANITIZER_FLAGS + _VARIANTS["tsan"][2] + ("-fPIC",))


def client_lib() -> Path:
    """Build (once) and return the ctypes client library.  Variant
    ``tsan`` hands out the TSan-instrumented twin and needs the TSan
    runtime preloaded into this process; ``asan`` / ``ubsan`` keep the
    standard client (the servers alone are instrumented)."""
    if native_variant() == "tsan":
        if not _tsan_runtime_preloaded():
            gxx = shutil.which("g++") or "g++"
            raise RuntimeError(
                "DISTLR_NATIVE_VARIANT=tsan needs the TSan runtime "
                "preloaded into this Python process: relaunch with "
                f"LD_PRELOAD=$({gxx} -print-file-name=libtsan.so) "
                "(dlopen-ing the instrumented client without it dies on "
                "a static-TLS allocation error)")
        return _tsan_client()
    return _standard_client()


def suppressions_file(variant: str | None = None) -> str | None:
    """The checked-in suppression file of ``variant`` (default: the
    active one; None for the standard build)."""
    v = _variant(variant)
    if not v:
        return None
    return str(NATIVE_DIR / f"{v}.supp")


def sanitizer_environ(base: dict | None = None, variant: str | None = None) -> dict | None:
    """Environment for spawning native processes under ``variant``
    (default: the active one).  The caller's options such as
    ``log_path`` and ``exitcode`` survive, but the host-only relaxations
    do not reach the native processes: ``suppressions=`` is forced to the
    checked-in file of the variant, and ``report_mutex_bugs=`` is
    dropped.  ASan's leak check is off unless the caller set
    ``detect_leaks`` (the matrix hunts memory errors, not the exit-time
    leaks of a terminated server).  None for the standard build: the
    spawn inherits this process's environment unchanged."""
    v = _variant(variant)
    if not v:
        return None
    env = dict(os.environ if base is None else base)
    var = _VARIANTS[v][1]
    # the runtimes take ':' as well as whitespace between options: split
    # on both, or a colon-joined string would carry a host relaxation
    # past the filter inside one token
    tokens = [t for t in re.split(r"[\s:]+", env.get(var, "")) if t
              and not t.startswith(("suppressions=", "report_mutex_bugs="))]
    supp = suppressions_file(v)
    if os.path.exists(supp):
        tokens.append(f"suppressions={supp}")
    if v == "asan" and not any(t.startswith("detect_leaks=") for t in tokens):
        tokens.append("detect_leaks=0")
    if tokens:
        env[var] = " ".join(tokens)
    return env


def build_sanitizers() -> dict[str, Path]:
    """Build the standard pair and every variant's artifacts at once (one
    ``g++`` each, in parallel): ``{name: path}``."""
    jobs = {"server": lambda: server_binary(""), "client": _standard_client,
            "client_tsan": _tsan_client}
    jobs.update({f"server_{v}": (lambda v=v: server_binary(v)) for v in VARIANTS})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv != ["sanitizers"]:
        print("usage: python -m distlr_tpu_torch.ps.build sanitizers", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    for name, path in build_sanitizers().items():
        print(f"{name}: {path}")
    print(f"built in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
