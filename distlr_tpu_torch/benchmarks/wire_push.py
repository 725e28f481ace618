"""What a gradient push costs on each wire codec: bytes, the push's host
time and the native encode's share of it.

One client pushes a seeded D-value gradient into an async group of
``servers`` native KV servers on this host (no BSP wait: the push alone)
as dense f32, int8 and signSGD; the encode is the client's own
``EncodeGrad`` (``ps/native/kv_protocol.h``) timed alone on the same
slices, from a small library built beside the KV client::

    python -m distlr_tpu_torch.benchmarks.wire_push [--dim 1000000] [--servers 2]

prints one JSON line: for each codec ``push_ms`` (mean over ``--reps``
pushes after one warm-up), ``encode_ms``, ``encode_share`` and
``raw_bytes`` / ``wire_bytes`` of one push.  Host-side only: it needs no
card, and its times are the host's CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from pathlib import Path

import numpy as np

from distlr_tpu_torch.compress import CODEC_IDS
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.ps.build import HEADER
from distlr_tpu_torch.utils import native

PROBE_SOURCE = Path(__file__).resolve().parent / "encode_probe.cc"


def _encode_fn():
    lib = ctypes.CDLL(str(native.build("libdistlr_torch_encode_probe", [PROBE_SOURCE, HEADER],
                                       shared=True)))
    fn = lib.distlr_encode_seconds
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    return fn


def push_costs(dim: int = 1_000_000, servers: int = 2, reps: int = 20, seed: int = 0) -> dict:
    """``{codec: {push_ms, encode_ms, encode_share, raw_bytes, wire_bytes}}``
    of one dense push of ``dim`` values over ``servers`` range servers."""
    g = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    encode = _encode_fn()
    out = {}
    for codec in ("none", "int8", "signsgd"):
        opt = "signsgd" if codec == "signsgd" else "sgd"
        with ServerGroup(servers, 1, dim, sync=False, learning_rate=1e-3,
                         optimizer=opt) as sg, \
                KVWorker(sg.hosts, dim, sync_group=False, compress=codec) as kv:
            if kv.compress_active != codec:
                raise RuntimeError(f"the group did not negotiate {codec!r}: "
                                   f"{kv.compress_active!r}")
            kv.push_init(np.zeros(dim, np.float32))
            kv.push(g)  # warm-up: the first push allocates the servers' buffers
            raw0, wire0 = kv.push_bytes_raw, kv.push_bytes_wire
            t0 = time.perf_counter()
            for _ in range(reps):
                kv.push(g)
            push_s = (time.perf_counter() - t0) / reps
            raw = (kv.push_bytes_raw - raw0) // reps
            wire = (kv.push_bytes_wire - wire0) // reps
        enc_s = 0.0
        if codec != "none":
            for r in range(servers):  # one coded frame a server's slice
                lo, hi = dim * r // servers, dim * (r + 1) // servers
                sl = np.ascontiguousarray(g[lo:hi])
                enc_s += encode(CODEC_IDS[codec], sl.ctypes.data, hi - lo, reps)
        out[codec] = {"push_ms": 1e3 * push_s, "encode_ms": 1e3 * enc_s,
                      "encode_share": enc_s / push_s, "raw_bytes": int(raw),
                      "wire_bytes": int(wire), "ratio": raw / wire}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=1_000_000)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps({"dim": args.dim, "servers": args.servers, "reps": args.reps,
                      **push_costs(args.dim, args.servers, args.reps, args.seed)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
