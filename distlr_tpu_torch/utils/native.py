"""Build the port's compiled artifacts: the scheme that ``ops/build.py``
(CUDA kernels, ``nvcc``) and the host-side C++ (the libsvm tokenizer, the
KV server and its client, ``g++``, here) share.

Each artifact is compiled from the sources in the checkout under a name
hashed from the bytes of its sources and the compiler flags: an edited
source builds anew, a stale artifact is never loaded.  A file lock for
each artifact serializes the processes that build it (test workers start
at once), and each build compiles to a private name and renames, so no
process loads a half-written file.  The host-side C++ lands in
``build/native/`` at the root of the checkout.  Nothing is built when a
module is imported.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra", "-fPIC", "-pthread")


def default_build_dir() -> Path:
    """``build/native`` at the root of the checkout (``.gitignore``d)."""
    return Path(__file__).resolve().parents[2] / "build" / "native"


def artifact_path(stem: str, sources, flags, build_dir: Path | None = None,
                  suffix: str = "") -> Path:
    """Where the artifact of ``sources`` (the compiled file first, then
    the headers it includes) built with ``flags`` lives."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        src = Path(src)
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return (build_dir or default_build_dir()) / f"{stem}-{h.hexdigest()[:16]}{suffix}"


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive ``flock`` on ``path``; the kernel drops it when the
    holder exits, so a killed build leaves no stale lock."""
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_once(out: Path, command, failure: str) -> Path:
    """Make ``out`` unless it exists: ``command(tmp)`` is the compiler
    command that writes ``tmp``, a private name beside ``out`` renamed onto
    it once the compiler succeeds.  A lock of ``out``'s own serializes the
    processes that build it (builds of other artifacts go on in parallel).
    Raises ``RuntimeError`` starting with ``failure`` and holding the
    compiler's output when the command fails."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with _file_lock(out.with_name(f".{out.name}.lock")):
        if out.exists():  # built by another process while this one waited
            return out
        tmp = out.with_name(f".{out.stem}.tmp{os.getpid()}-{threading.get_ident()}{out.suffix}")
        tmp.touch()
        try:
            proc = subprocess.run(command(tmp), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{failure} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
    return out


def build(stem: str, sources, *, shared: bool, flags=CXX_FLAGS,
          build_dir: Path | None = None) -> Path:
    """Compile ``sources[0]`` (``sources[1:]`` are the headers it
    includes, hashed with it) with ``g++`` into ``build_dir`` unless its
    hashed artifact exists; a shared library when ``shared``, else an
    executable.  Returns the artifact's path."""
    out = artifact_path(stem, sources, flags, build_dir, ".so" if shared else "")
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native code needs a C++17 compiler")
    return build_once(
        out, lambda tmp: [cxx, *flags, *(("-shared",) if shared else ()), "-o", str(tmp),
                          str(sources[0])],
        f"g++ failed on {Path(sources[0]).name}")
