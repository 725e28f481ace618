"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/kernels/`` at the root of the
checkout; its file name carries a hash of the sources and flags, so an
edited source builds anew and a stale library is never loaded (the
scheme of :mod:`distlr_tpu_torch.utils.native`, shared with the
host-side C++).  Nothing
is built when this module is imported: the first kernel call builds.
A variant with preprocessor ``defines`` (an instrumented build) gets a
library of its own.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path

from distlr_tpu_torch.utils import native

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def default_build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (``.gitignore``d)."""
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _sources(name: str) -> list[Path]:
    srcs = [CSRC_DIR / f"{name}.cu"]
    return srcs + sorted(CSRC_DIR.glob("*.cuh"))


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, build_dir: Path | None = None,
                 defines: tuple[str, ...] = ()) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives: hashed on the
    bytes of its sources and the compiler flags."""
    return native.artifact_path(f"lib{name}", _sources(name), _flags(defines),
                                build_dir or default_build_dir(), ".so")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH and CUDA_HOME): the CUDA toolkit is needed "
        "to build the port's kernels")


def nvcc_command(name: str, out: Path, defines: tuple[str, ...] = ()) -> list[str]:
    return [find_nvcc(), *_flags(defines), "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(name: str, build_dir: Path | None = None, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``)
    unless its hashed library exists; return the library's path.  Raises
    with the compiler's output when ``nvcc`` fails."""
    return native.build_once(library_path(name, build_dir, defines),
                             lambda tmp: nvcc_command(name, tmp, defines),
                             f"nvcc failed on {name}.cu")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``csrc/<name>.cu``'s library once per
    process."""
    return ctypes.CDLL(str(build(name)))
