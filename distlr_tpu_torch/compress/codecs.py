"""Numpy reference of the gradient wire codecs (the port's copy of
``distlr_tpu/compress/codecs.py``).

They mirror the native ``EncodeGrad`` / ``DecodeGrad`` of
``ps/native/kv_protocol.h`` bit for bit: the same block size, the same
``amax/127`` symmetric scale, the same round-half-to-even (``np.rint``
is ``nearbyintf``), the same LSB-first sign bitmap.  They are the oracle
the wire-parity checks hold the servers' state to, and the byte
calculators of the push accounting.  The training path never runs them:
clients encode in the native library, servers decode as they parse.

=========  =====================================  ==================
codec      value payload of n coordinates         bytes (vs 4n dense)
=========  =====================================  ==================
``none``   n float32                              ``4n``
``int8``   ceil(n/256) f32 scales + n int8        ``~n + n/64``
``signsgd``  ceil(n/8) bitmap bytes               ``n/8``
=========  =====================================  ==================

An int8 decode is off by at most ``scale/2`` a coordinate (scale = the
block's ``amax/127``).  ``signsgd`` keeps only the sign; it means
something only against the servers' majority vote
(``--optimizer=signsgd``) and needs a signSGD-scale learning rate.
"""

from __future__ import annotations

import numpy as np

from distlr_tpu_torch.ps import wire

#: int8 block-quantization granularity (values per f32 scale): kQuantBlock
QUANT_BLOCK = wire.QUANT_BLOCK

#: wire codec ids (kv_protocol.h Codec) by their --ps-compress name
CODEC_IDS = {
    "none": wire.CODEC_NONE,
    "int8": wire.CODEC_INT8,
    "signsgd": wire.CODEC_SIGN,
}
CODECS = tuple(CODEC_IDS)


def payload_bytes(codec: str, n: int) -> int:
    """Exact value-payload bytes of a coded frame carrying ``n`` values
    (the native ``CodecPayloadBytes``)."""
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown codec {codec!r} (choose from {CODECS})")
    return wire.codec_payload_bytes(CODEC_IDS[codec], n)


def encode_int8(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Block-symmetric int8 quantization: ``(scales, q)`` with one f32
    scale a :data:`QUANT_BLOCK` values, ``q = rint(v/scale)`` clamped to
    [-127, 127] (ties to even, as ``nearbyintf``)."""
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    n = v.size
    nb = (n + QUANT_BLOCK - 1) // QUANT_BLOCK
    padded = np.zeros(nb * QUANT_BLOCK, np.float32)
    padded[:n] = v
    blocks = padded.reshape(nb, QUANT_BLOCK)
    scales = (np.abs(blocks).max(axis=1) / np.float32(127.0)).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1.0))
    q = np.clip(np.rint(blocks / safe[:, None]), -127, 127)
    q = np.where(scales[:, None] > 0, q, 0.0).astype(np.int8)
    return scales, q.reshape(-1)[:n]


def decode_int8(scales: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_int8`: ``v = q * scale`` in f32."""
    q = np.asarray(q, np.int8)
    scales = np.asarray(scales, np.float32)
    idx = np.arange(q.size) // QUANT_BLOCK
    return (q.astype(np.float32) * scales[idx]).astype(np.float32)


def int8_roundtrip(v: np.ndarray) -> np.ndarray:
    """``decode(encode(v))``: what a server's optimizer sees of an
    int8-coded push."""
    return decode_int8(*encode_int8(v))


def int8_error_bound(v: np.ndarray) -> np.ndarray:
    """Worst-case quantization error a coordinate: half its block's scale
    (+1 ulp of slack for the f32 divide and multiply)."""
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    n = v.size
    nb = (n + QUANT_BLOCK - 1) // QUANT_BLOCK
    padded = np.zeros(nb * QUANT_BLOCK, np.float32)
    padded[:n] = v
    scales = np.abs(padded.reshape(nb, QUANT_BLOCK)).max(axis=1) / 127.0
    per = scales[np.arange(n) // QUANT_BLOCK]
    return (per / 2.0 + np.abs(v) * 1e-6).astype(np.float32)


def encode_sign(v: np.ndarray) -> np.ndarray:
    """1-bit signSGD encoding: LSB-first bitmap, bit i = (v_i > 0).  An
    exact zero encodes as 0 and decodes as -1."""
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    return np.packbits((v > 0).astype(np.uint8), bitorder="little")


def decode_sign(bitmap: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`encode_sign`: ±1 float32 a coordinate."""
    bits = np.unpackbits(np.asarray(bitmap, np.uint8), count=n, bitorder="little")
    return np.where(bits > 0, np.float32(1.0), np.float32(-1.0))


def sign_roundtrip(v: np.ndarray) -> np.ndarray:
    """The ±1 vector a signSGD server decodes from a coded push of ``v``:
    a worker's vote in the majority-vote oracle."""
    return decode_sign(encode_sign(v), np.asarray(v).size)
