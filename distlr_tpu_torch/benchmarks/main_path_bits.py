"""Digests of the main path's kernel outputs at the full width, on the card.

    python -m distlr_tpu_torch.benchmarks.main_path_bits

Runs ``fused_lr_grad`` (with its logits) and ``lr_logits`` at the trainer's
shape, (2048, 1M) bf16 features, under both compute types, and prints one
JSON line with a digest of each output's bytes beside the digests recorded
in :data:`RECORDED`.  A change to the single pass or the streaming logits
that moves any bit of g or z (a new sum order, another rounding) changes a
digest; a change to how the kernels move data does not.

The inputs are made on the card from an integer hash of each element's
index (:func:`hashed_uniform`), so they have the same bits on any machine
and under any PyTorch version.  The outputs' bits also depend on the
launch plan, which follows the SM count, and on the compiler: the digests
hold for the card and toolkit that :data:`RECORDED` names.

The script imports nothing from the package but ``ops`` and its wrappers,
so it can digest another checkout's kernels: run it by path with that
checkout first on ``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

B, D, MASKED = 2048, 1_000_000, 48
COMPUTE_DTYPES = ("bfloat16", "float32")
_M32 = 0xFFFFFFFF

#: digests (the first 16 hex digits of the sha256 of each output's bytes)
#: recorded on an "NVIDIA H100 80GB HBM3" (132 SMs) with nvcc 12.9 from
#: the kernel sources of commit eb3e951; the sources that reorder the
#: streaming kernel's prologue and load w's slice with 16-byte loads gave
#: the same digests in the same run
RECORDED = {
    "sms": 132,
    "digests": {
        "grad_bfloat16": "633ab6116cf9e6cf",
        "grad_logits_bfloat16": "59b2fa7bc86e3291",
        "logits_bfloat16": "da20fd63f8a85704",
        "grad_float32": "98edf5eaf38f68c6",
        "grad_logits_float32": "2b0d12842f643dca",
        "logits_float32": "d525b2a3493b714c",
    },
}


def hashed_uniform(shape, salt: int, device, chunk: int = 1 << 27) -> torch.Tensor:
    """f32 values in [-1, 1), each from a 32-bit integer hash of its flat
    index and ``salt`` (multiply-xorshift; every product stays below
    2**63), made ``chunk`` elements at a time."""
    n = 1
    for s in shape:
        n *= s
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, chunk):
        h = torch.arange(start, min(start + chunk, n), dtype=torch.int64, device=device)
        h = ((h & _M32) * 0x61C88647 + (salt + 1) * 0x7FEB352D) & _M32
        h ^= h >> 16
        h = (h * 0x7FEB352D) & _M32
        h ^= h >> 15
        h = (h * 0x68E31DA5) & _M32
        h ^= h >> 16
        # the top 24 bits, exact in f32
        out[start:start + h.numel()] = (h >> 8).to(torch.float32) * 2.0 ** -23 - 1.0
    return out.view(*shape)


def hashed_inputs(b: int, d: int, device, masked: int = MASKED):
    """(w, X, y, mask) of the digest: X bf16, w scaled by 1/sqrt(d), labels
    from the hash's sign, the last ``masked`` rows masked."""
    X = hashed_uniform((b, d), 0, device).to(torch.bfloat16)
    w = hashed_uniform((d,), 1, device) / d ** 0.5
    y = (hashed_uniform((b,), 2, device) < 0).to(torch.int32)
    mask = torch.ones(b, device=device)
    if masked:
        mask[-masked:] = 0
    return w, X, y, mask


def digest(t: torch.Tensor) -> str:
    raw = t.detach().cpu().contiguous().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def main_path_digests(device) -> dict:
    """Output name -> digest at (B, D); each output comes from the kernel
    the main path launches (the single pass's counter must move)."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    w, X, y, mask = hashed_inputs(B, D, device)
    out = {}
    for cd in COMPUTE_DTYPES:
        before = ops.fused_lr_grad.launches
        g, z = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd, with_logits=True)
        if ops.fused_lr_grad.launches != before + 1:
            raise AssertionError(f"({B}, {D}) did not take the single pass")
        before = ops.lr_logits.launches
        zl = ops.lr_logits(w, X, compute_dtype=cd)
        if ops.lr_logits.launches != before + 1:
            raise AssertionError(f"({B}, {D}) did not take the streaming logits")
        out.update({f"grad_{cd}": digest(g), f"grad_logits_{cd}": digest(z),
                    f"logits_{cd}": digest(zl)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("main_path_bits: needs the card (CUDA is not available)", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    got = main_path_digests(device)
    print(json.dumps({"B": B, "D": D, "sms": sms, "digests": got,
                      "matches_recorded": sms == RECORDED["sms"] and got == RECORDED["digests"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
