"""Bitwise reproduction of glibc ``rand()`` for reference init parity
(copy of ``distlr_tpu/utils/reference_rng.py``).

The reference initializes weights as ``rand()/RAND_MAX`` after
``srand(random_state)`` (reference ``src/lr.cc:92-98``, default state 0 per
``include/lr.h:10``; every worker computes the identical vector — SURVEY.md
Q2).  To validate bitwise-identical initial weights against a reference
run, this module re-implements glibc's TYPE_3 additive-feedback generator
(the documented algorithm, e.g. the glibc manual's random_r description):

* ``r[0] = seed`` (glibc maps seed 0 -> 1)
* ``r[i] = 16807 * r[i-1] mod 2^31-1`` for i in 1..30 (Lehmer stepping,
  computed without overflow)
* ``r[i] = r[i-31]`` for i in 31..33
* ``r[i] = (r[i-3] + r[i-31]) mod 2^32`` for i >= 34
* srandom discards the first 310 outputs (10 x degree warm-up), so
  ``rand()`` call k returns ``r[k+344] >> 1``
"""

from __future__ import annotations

import numpy as np

GLIBC_RAND_MAX = 2147483647  # 2^31 - 1


def glibc_rand_sequence(seed: int, n: int) -> np.ndarray:
    """First ``n`` outputs of glibc ``rand()`` after ``srand(seed)``."""
    seed = seed & 0xFFFFFFFF
    if seed == 0:
        seed = 1
    warmup = 310
    total = n + 34 + warmup
    state = np.empty(total, dtype=np.uint64)
    state[0] = seed
    for i in range(1, 31):
        # 16807 * r mod 2^31-1 (Schrage in glibc; plain 64-bit mod here).
        state[i] = (16807 * int(state[i - 1])) % 2147483647
    for i in range(31, 34):
        state[i] = state[i - 31]
    for i in range(34, total):
        state[i] = (state[i - 3] + state[i - 31]) & 0xFFFFFFFF
    return (state[34 + warmup :] >> np.uint64(1)).astype(np.int64)


def reference_init_weights(num_features: int, seed: int = 0) -> np.ndarray:
    """The reference's exact initial weight vector: uniform [0,1) as
    float32 ``rand()/RAND_MAX`` draws (``src/lr.cc:92-98``)."""
    draws = glibc_rand_sequence(seed, num_features)
    return (
        draws.astype(np.float32) / np.float32(GLIBC_RAND_MAX)
    ).astype(np.float32)
