"""The Python mirror of the native wire protocol constants (the port's
copy of ``distlr_tpu/ps/wire.py``).

``ps/native/kv_protocol.h`` is the single C++ definition of the KV frame
layout; this module is its Python definition in the port, a verbatim copy
of the JAX package's constants so that the port's client and server speak
its protocol byte for byte.  Import-free (stdlib ``struct`` only).
"""

from __future__ import annotations

import struct

#: frame magic (kv_protocol.h kMagic)
MAGIC = 0xD157C0DE

# --- Op codes (enum class Op) ------------------------------------------
OP_PUSH = 1
OP_PULL = 2
OP_BARRIER = 3
OP_SHUTDOWN = 4
OP_HELLO = 5
OP_STATS = 6
OP_PUSH_PULL = 7
OP_EPOCH = 8

# --- Flags bits (enum Flags) -------------------------------------------
FLAG_NONE = 0
FLAG_RESPONSE = 1
FLAG_ERROR = 2
FLAG_INIT_PUSH = 4
FLAG_FORCE_INIT = 8
#: bits 4-5 carry the gradient codec of a push-class value payload
CODEC_SHIFT = 4
CODEC_MASK = 0x30
#: the op addresses FTRL z/n accumulators (2x vals per key)
FLAG_OPT_STATE = 64
#: a 16-byte TraceFrame trailer follows the header (before the keys)
FLAG_TRACED = 128

# --- gradient wire codecs (enum Codec) ---------------------------------
CODEC_NONE = 0
CODEC_INT8 = 1
CODEC_SIGN = 2

#: int8 block-quantization granularity, values per f32 scale (kQuantBlock)
QUANT_BLOCK = 256

# --- kHello capability bits --------------------------------------------
CAP_CODEC_INT8 = 1 << CODEC_INT8
CAP_CODEC_SIGN = 1 << CODEC_SIGN
CAP_TRACE = 1 << 8
CAP_EPOCH = 1 << 9

# --- kStats reply shape ------------------------------------------------
#: the original six integer counters every vintage replies (kStatsValsV1)
STATS_VALS_V1 = 6
#: current stats count: v1 six + 4 per-handler CPU seconds + epoch
STATS_VALS = 11

#: wire-corruption guard for vals_per_key (kMaxValsPerKey)
MAX_VALS_PER_KEY = 4096

#: the 16-bit MsgHeader::aux field's ceiling — barrier generation ids
#: and membership epochs both ride it, so both are capped here (the
#: header has no named constant; this pins the u16 wire width)
AUX_MAX = 0xFFFF

# --- frame structs -----------------------------------------------------
#: MsgHeader wire layout: magic u32, op u8, flags u8, aux u16,
#: client_id u32, timestamp u32, num_keys u64 — little-endian, packed
HEADER_STRUCT = struct.Struct("<IBBHIIQ")
#: static_assert(sizeof(MsgHeader) == 24) twin
HEADER_SIZE = 24

#: TraceFrame trailer: trace_id u64, span_id u64
TRACE_FRAME_STRUCT = struct.Struct("<QQ")
#: static_assert(sizeof(TraceFrame) == 16) twin
TRACE_FRAME_SIZE = 16

# The struct formats must agree with the asserted C sizes — checked at
# import so a format edit can never ship a silently-misframed parser
# (the lint re-checks both against the header's static_asserts).
assert HEADER_STRUCT.size == HEADER_SIZE
assert TRACE_FRAME_STRUCT.size == TRACE_FRAME_SIZE


def codec_of(flags: int) -> int:
    """Codec id of a push-class frame's flags (native ``CodecOf``)."""
    return (flags & CODEC_MASK) >> CODEC_SHIFT


def codec_payload_bytes(codec: int, n: int) -> int:
    """Exact value-payload bytes of a coded frame carrying ``n`` values
    (native ``CodecPayloadBytes`` — both sides derive the size from
    ``(codec, n)``, so coded frames need no extra length field)."""
    if codec == CODEC_INT8:
        return ((n + QUANT_BLOCK - 1) // QUANT_BLOCK) * 4 + n
    if codec == CODEC_SIGN:
        return (n + 7) // 8
    return 4 * n
