"""Gradient compression on the PS wire (the port's copy of
``distlr_tpu/compress/``).

Two levers that multiply:

* **wire codecs** (:mod:`distlr_tpu_torch.compress.codecs`): the value
  payload of every gradient push crosses the wire int8 block-quantized
  (``--ps-compress int8``, ~3.9x fewer value bytes, error <= scale/2) or
  as 1-bit signSGD (``--ps-compress signsgd``, 32x, majority-vote
  aggregation on the servers).  The codec is negotiated a connection
  through the kHello capability handshake: a group that does not
  advertise it gets dense f32 pushes, and the client logs the fallback.
  Encode and decode run in the native client and server
  (``ps/native/kv_protocol.h``); this package holds their bit-exact
  numpy reference, the oracle of the parity tests.

* **AdaBatch accumulation** (:mod:`distlr_tpu_torch.compress.accum`):
  push the MEAN gradient every k batches, k growing on a schedule
  (``--accum-start`` / ``--accum-max``).

``--ps-compress none`` (the default) negotiates nothing: not one wire
byte differs from an uncompressed run.
"""

from distlr_tpu_torch.compress.accum import GradientAccumulator
from distlr_tpu_torch.compress.codecs import (
    CODEC_IDS,
    CODECS,
    QUANT_BLOCK,
    decode_int8,
    decode_sign,
    encode_int8,
    encode_sign,
    int8_error_bound,
    int8_roundtrip,
    payload_bytes,
    sign_roundtrip,
)

__all__ = [
    "CODEC_IDS",
    "CODECS",
    "QUANT_BLOCK",
    "GradientAccumulator",
    "decode_int8",
    "decode_sign",
    "encode_int8",
    "encode_sign",
    "int8_error_bound",
    "int8_roundtrip",
    "payload_bytes",
    "sign_roundtrip",
]
