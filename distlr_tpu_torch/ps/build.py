"""Build and locate the port's native PS components: the KV server binary
and the ctypes client library.

The port's own copies of ``kv_server.cc``, ``kv_client.cc`` and
``kv_protocol.h`` (``ps/native/``) are compiled with ``g++`` and the JAX
package's standard flags (``distlr_tpu/ps/native/Makefile``) into
``build/native/`` at the root of the checkout, each under a name hashed
from its source, the protocol header and the flags, behind a file lock
of its own (:mod:`distlr_tpu_torch.utils.native`).  The sanitizer builds of the JAX
package wait for ROADMAP A.16.7.
"""

from __future__ import annotations

from pathlib import Path

from distlr_tpu_torch.utils import native

NATIVE_DIR = Path(__file__).resolve().parent / "native"
HEADER = NATIVE_DIR / "kv_protocol.h"
SERVER_SOURCE = NATIVE_DIR / "kv_server.cc"
CLIENT_SOURCE = NATIVE_DIR / "kv_client.cc"


def server_binary() -> Path:
    """Build (once) and return the KV server executable."""
    return native.build("distlr_torch_kv_server", [SERVER_SOURCE, HEADER], shared=False)


def client_lib() -> Path:
    """Build (once) and return the ctypes client library."""
    return native.build("libdistlr_torch_kv", [CLIENT_SOURCE, HEADER], shared=True)
