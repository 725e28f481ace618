"""The port's on-device generation probes (``ops/gen_roofline.py``) against
the JAX package's Pallas roofline kernels, on the CPU.

The Pallas bodies of ``benchmarks/exp_gen_roofline*.py`` run through
Pallas's TPU interpret mode at ``BT, DT, REPS = 8, 256, 4``, set on the
imported modules.  Their hardware generator has no CPU counterpart (the
interpreter yields all-zero bits), so for rows 2 and 3 the modules'
``pltpu`` is replaced by a shim whose ``prng_random_bits`` computes the
port's Philox4x32-10 bits in ``jnp`` uint32 arithmetic.  ``_kern_full``
writes each output block in its second phase only, which neither
interpreter runs faithfully, so row 4 is held against a float64 numpy
transcription of its body fed the same bits.

On CPU tensors the port's wrappers take their plain PyTorch versions; the
CUDA kernels are held against those versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from distlr_tpu_torch import ops
from distlr_tpu_torch.ops import gen_roofline as gr

roof1 = importlib.import_module("benchmarks.exp_gen_roofline")
roof2 = importlib.import_module("benchmarks.exp_gen_roofline2")

BT, DT, REPS = 8, 256, 4
SEED = 1234567


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are small: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_tile(monkeypatch):
    for mod in (roof1, roof2):
        monkeypatch.setattr(mod, "BT", BT)
        monkeypatch.setattr(mod, "DT", DT)
        monkeypatch.setattr(mod, "REPS", REPS)


def _rel(a, ref) -> float:
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max())


# --- Philox in jnp uint32, for the PRNG shim ---------------------------------
def _mulhilo(a: int, b):
    """High and low words of the 32x32-bit product of the constant ``a``
    and uint32 ``b``, from 16-bit halves (no 64-bit integers in JAX here)."""
    a_lo, a_hi = jnp.uint32(a & 0xFFFF), jnp.uint32(a >> 16)
    b_lo, b_hi = b & jnp.uint32(0xFFFF), b >> 16
    p0, p1, p2, p3 = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (p0 >> 16) + (p1 & jnp.uint32(0xFFFF)) + (p2 & jnp.uint32(0xFFFF))
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi, jnp.uint32(a) * b


def _jnp_philox_bits(seed, t, shape):
    """The port's bits of step ``t`` (see ``philox_bits_reference``)."""
    r = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    idx = r * jnp.uint32(shape[1]) + c
    c0, c1, c2, c3 = idx >> 2, *(jnp.zeros(shape, jnp.uint32),) * 3
    k0 = jnp.asarray(seed).astype(jnp.uint32)
    k1 = jnp.asarray(t).astype(jnp.uint32)
    for i in range(10):
        if i:
            k0, k1 = k0 + jnp.uint32(0x9E3779B9), k1 + jnp.uint32(0xBB67AE85)
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    word = idx & 3
    out = jnp.where(word == 0, c0, jnp.where(word == 1, c1, jnp.where(word == 2, c2, c3)))
    return jax.lax.bitcast_convert_type(out, jnp.int32)


def _prng_shim():
    key = {}

    def prng_seed(s, t):
        key["s"], key["t"] = s, t

    def prng_random_bits(shape):
        return _jnp_philox_bits(key["s"], key["t"], shape)

    return types.SimpleNamespace(prng_seed=prng_seed, prng_random_bits=prng_random_bits)


def _interpret():
    return pltpu.InterpretParams()


def _seed_np():
    return np.array([SEED], np.int32)


def _seed_t():
    return torch.tensor([SEED], dtype=torch.int32)


def _w(seed=0, n=DT):
    return np.random.default_rng(seed).standard_normal((1, n)).astype(np.float32)


# --- Philox ---------------------------------------------------------------------
class TestPhilox:
    M32 = 0xFFFFFFFF

    @pytest.mark.parametrize("counter,key,expect", [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ])
    def test_known_answers(self, counter, key, expect):
        """Random123's known-answer vectors for Philox4x32-10."""
        words = gr.philox4x32_10(torch.tensor([counter[0]]), *key, *counter[1:])
        assert [int(w) for w in words] == list(expect)

    def test_bits_reference_layout(self):
        """Element (r, c) is word (r*DT + c) & 3 of block (r*DT + c) >> 2;
        counter 0 under key (0, 0) is the first known-answer vector."""
        bits = gr.philox_bits_reference(0, 0, 2, 8).numpy().view(np.uint32)
        assert list(bits[0, :4]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
        words = gr.philox4x32_10(torch.tensor([3]), 0, 0)
        assert list(bits[1, 4:]) == [int(w) for w in words]

    def test_jnp_shim_matches_reference(self):
        """The shim the Pallas bodies see gives the port's bits."""
        got = np.asarray(_jnp_philox_bits(np.int32(SEED), np.int32(3), (BT, DT)))
        want = gr.philox_bits_reference(SEED, 3, BT, DT).numpy()
        np.testing.assert_array_equal(got, want)

    def test_bit_frequencies(self):
        """Each of the 32 bit positions is set in half the words: 2**18
        words, so 5 standard deviations are 0.0049."""
        bits = gr.philox_bits_reference(7, 11, 256, 1024).numpy().view(np.uint32)
        freq = ((bits[..., None] >> np.arange(32, dtype=np.uint32)) & 1).mean(axis=(0, 1))
        assert np.abs(freq - 0.5).max() < 0.0049

    def test_x_range_and_moments(self):
        """x = f32(int32 bits) * 2**-31 - 1 lies in [-2, 0) (the TPU
        comment's U[-1, 1) does not hold for int32 bits), with mean -1 and
        variance 1/3.  For 2**18 draws 5 standard errors of the mean are
        0.0056, of the variance 0.0029."""
        x = gr._bits_to_x(gr.philox_bits_reference(3, 0, 256, 1024)).double()
        assert -2.0 <= float(x.min()) and float(x.max()) < 0.0
        assert abs(float(x.mean()) + 1.0) < 0.0056
        assert abs(float(x.var()) - 1.0 / 3.0) < 0.0029

    def test_steps_and_seeds_differ(self):
        a = gr.philox_bits_reference(0, 0, 4, 64)
        assert not torch.equal(a, gr.philox_bits_reference(0, 1, 4, 64))
        assert not torch.equal(a, gr.philox_bits_reference(1, 0, 4, 64))


# --- rows 2-4: exp_gen_roofline.py ------------------------------------------------
class TestGenRooflineParity:
    def test_gen_matches_pallas_exactly(self, monkeypatch):
        """Row 2: both sum f32 words over ascending t, so bit for bit."""
        monkeypatch.setattr(roof1, "pltpu", _prng_shim())
        f = pl.pallas_call(
            roof1._kern_gen,
            grid=(REPS,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((BT, 128), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((BT, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((BT, 128), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(_seed_np())))
        got = ops.roofline_gen(_seed_t(), bt=BT, dt=DT, reps=REPS).numpy()
        assert np.abs(want).max() > 2**30
        np.testing.assert_array_equal(got, want)

    def test_fwd_matches_pallas(self, monkeypatch):
        """Row 3: f32 sums in another order."""
        monkeypatch.setattr(roof1, "pltpu", _prng_shim())
        w = _w()
        f = pl.pallas_call(
            roof1._kern_fwd,
            grid=(REPS,),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec((1, DT), lambda t: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BT, 1), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((BT, 1), jnp.float32),
            scratch_shapes=[pltpu.VMEM((BT, 1), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(_seed_np()), jnp.asarray(w)))
        got = ops.roofline_fwd(_seed_t(), torch.from_numpy(w), bt=BT, reps=REPS).numpy()
        assert got.shape == want.shape == (BT, 1)
        assert _rel(got, want.astype(np.float64)) <= 1e-5

    @staticmethod
    def _full_oracle(bits, w, y):
        """float64 numpy transcription of ``_kern_full``: phase 0 sums z
        over every step, phase 1 writes each step's block of g."""
        xs = [b.astype(np.float64) * 2.0**-31 - 1.0 for b in bits]
        z = sum((x * w).sum(axis=1, keepdims=True) for x in xs)
        r = 1.0 / (1.0 + np.exp(-z)) - y
        return np.concatenate([(x * r).sum(axis=0, keepdims=True) for x in xs], axis=1)

    def test_full_matches_float64_oracle(self):
        """Row 4 on the port's Philox bits."""
        w = _w(1) * 0.05
        y = (np.random.default_rng(2).random((BT, 1)) < 0.5).astype(np.float32)
        bits = [gr.philox_bits_reference(SEED, t, BT, DT).numpy() for t in range(REPS)]
        got = ops.roofline_full(_seed_t(), torch.from_numpy(w), torch.from_numpy(y),
                                reps=REPS).numpy()
        assert got.shape == (1, REPS * DT)
        assert _rel(got, self._full_oracle(bits, w, y)) <= 1e-5

    def test_full_zero_bits_matches_oracle(self):
        """Row 4 on all-zero bits, what the interpreter's generator gives:
        x = -1 everywhere."""
        w = _w(3) * 0.05
        y = (np.random.default_rng(4).random((BT, 1)) < 0.5).astype(np.float32)
        zeros = lambda t: torch.zeros(BT, DT, dtype=torch.int32)  # noqa: E731
        got = gr._full_from_bits(zeros, torch.from_numpy(w), torch.from_numpy(y), REPS).numpy()
        want = self._full_oracle([np.zeros((BT, DT), np.int32)] * REPS, w, y)
        assert _rel(got, want) <= 1e-5

    def test_full_phase0_is_fwd(self):
        """Phase 0 of row 4 is row 3: the residual it uses comes from the
        same logits."""
        w = _w(5)
        y = np.zeros((BT, 1), np.float32)
        z = ops.roofline_fwd(_seed_t(), torch.from_numpy(w), bt=BT, reps=REPS)
        g = ops.roofline_full(_seed_t(), torch.from_numpy(w), torch.from_numpy(y), reps=REPS)
        bits = [gr.philox_bits_reference(SEED, t, BT, DT).numpy() for t in range(REPS)]
        xs = np.stack([b.astype(np.float64) * 2.0**-31 - 1.0 for b in bits])
        g_from_z = (xs * torch.sigmoid(z).double().numpy()).sum(axis=1).reshape(1, -1)
        assert _rel(g.numpy(), g_from_z) <= 1e-5


# --- rows 5-7: exp_gen_roofline2.py -----------------------------------------------
class TestGenRoofline2Parity:
    def test_hash_matches_pallas(self):
        """Row 5: the same int32 hash bits, f32 sums in another order."""
        w = _w(6)
        f = pl.pallas_call(
            roof2._kern_hash,
            grid=(REPS,),
            in_specs=[pl.BlockSpec((1, DT), lambda t: (0, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((BT, 1), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((BT, 1), jnp.float32),
            scratch_shapes=[pltpu.VMEM((BT, 1), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(w)))
        got = ops.roofline_hash(torch.from_numpy(w), bt=BT, reps=REPS).numpy()
        assert _rel(got, want.astype(np.float64)) <= 1e-5

    def test_hash_x_matches_jnp_transcription(self):
        """The hash itself, element for element, against the Pallas body's
        int32 arithmetic run by XLA on the CPU."""
        t = 3
        row = jax.lax.broadcasted_iota(jnp.int32, (BT, DT), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (BT, DT), 1)
        h = row * jnp.int32(-1640531527) + col * jnp.int32(-2048144777) + t
        h = h ^ jax.lax.shift_right_logical(h, 15)
        h = h * jnp.int32(739993453)
        h = h ^ jax.lax.shift_right_logical(h, 12)
        want = np.asarray(h.astype(jnp.float32) * (2.0 ** -31))
        np.testing.assert_array_equal(gr.hash_x_reference(t, BT, DT).numpy(), want)

    def test_const_matches_pallas(self):
        """Row 6: REPS accumulations of the same row dot."""
        rng = np.random.default_rng(7)
        x = rng.standard_normal((BT, DT)).astype(np.float32)
        w = _w(8)
        f = pl.pallas_call(
            roof2._kern_const,
            grid=(REPS,),
            in_specs=[
                pl.BlockSpec((BT, DT), lambda t: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, DT), lambda t: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BT, 1), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((BT, 1), jnp.float32),
            scratch_shapes=[pltpu.VMEM((BT, 1), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(w)))
        got = ops.roofline_const(torch.from_numpy(x), torch.from_numpy(w), reps=REPS).numpy()
        assert _rel(got, want.astype(np.float64)) <= 1e-5

    def test_mxu_matches_pallas(self):
        """Row 7: bf16 operands, f32 sums in another order."""
        rng = np.random.default_rng(9)
        x = rng.standard_normal((BT, DT)).astype(np.float32)
        w = rng.standard_normal((DT, 128)).astype(np.float32)
        f = pl.pallas_call(
            roof2._kern_mxu,
            grid=(REPS,),
            in_specs=[
                pl.BlockSpec((BT, DT), lambda t: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((DT, 128), lambda t: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BT, 128), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((BT, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((BT, 128), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(w)))
        got = ops.roofline_mxu(torch.from_numpy(x), torch.from_numpy(w), reps=REPS).numpy()
        assert got.shape == (BT, 128)
        assert _rel(got, want.astype(np.float64)) <= 1e-5


# --- the wrappers' checks on the CPU --------------------------------------------------
class TestWrappers:
    def test_launch_counters_stay_zero_on_cpu(self):
        ops.reset_launch_counts()
        w = torch.from_numpy(_w())
        ops.roofline_gen(_seed_t(), bt=BT, dt=DT, reps=1)
        ops.roofline_fwd(_seed_t(), w, bt=BT, reps=1)
        ops.roofline_hash(w, bt=BT, reps=1)
        assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)

    @pytest.mark.parametrize("call,err,match", [
        (lambda: ops.roofline_gen(torch.tensor([1.0])), TypeError, "seed must be torch.int32"),
        (lambda: ops.roofline_gen(torch.tensor([1, 2], dtype=torch.int32)), ValueError, r"seed must be \(1,\)"),
        (lambda: ops.roofline_fwd(_seed_t(), torch.ones(DT)), ValueError, "w must be"),
        (lambda: ops.roofline_full(_seed_t(), torch.ones(1, DT), torch.ones(BT)), ValueError, "y must be"),
        (lambda: ops.roofline_const(torch.ones(DT), torch.ones(1, DT)), ValueError, "x must be"),
        (lambda: ops.roofline_mxu(torch.ones(BT, DT), torch.ones(DT, 64)), ValueError, "w must be"),
        (lambda: ops.roofline_hash(torch.ones(1, DT), reps=0), ValueError, "reps"),
        (lambda: ops.roofline_const(torch.ones(BT, DT, dtype=torch.float64),
                                    torch.ones(1, DT)), TypeError, "x must be torch.float32"),
    ])
    def test_bad_inputs_raise(self, call, err, match):
        with pytest.raises(err, match=match):
            call()

    def test_probe_plan_at_the_published_tile(self):
        """const is one launch of 128 two-row blocks with no scratch; mxu
        128 blocks of 4 row strips x 32 depth slices, then the slices' sum
        over a 32-slab scratch."""
        const = gr.probe_plan("const")
        assert const == dict(kernels=("const_rows_kernel",), blocks=128, threads=512, scratch=0)
        mxu = gr.probe_plan("mxu")
        assert mxu["kernels"] == ("mxu_wgmma_kernel", "sum_partials_kernel")
        assert mxu["blocks"] == (8192 // 256) * (256 // 64) == 128
        assert mxu["threads"] == 256  # a consumer and a producer warpgroup
        assert mxu["scratch"] == 32 * 256 * 128
        assert [len(gr.probe_plan(n)["kernels"]) for n in ("gen", "fwd", "full", "hash")] == [1, 2, 3, 2]
        assert gr.probe_plan("gen")["scratch"] == 256 * 8192 // 4 // 256 * 8
        assert gr.probe_plan("fwd")["scratch"] == gr.probe_plan("hash")["scratch"] == 8 * 256

    @pytest.mark.parametrize("bt,dt,blocks", [(1, 128, 1), (5, 384, 3), (255, 8192, 128),
                                              (256, 16384, 128)])
    def test_const_blocks_own_two_rows(self, bt, dt, blocks):
        plan = gr.probe_plan("const", bt, dt)
        assert plan["blocks"] == blocks and plan["scratch"] == 0

    @pytest.mark.parametrize("bt,dt", [(64, 256), (128, 2048), (512, 1024)])
    def test_mxu_blocks_tile_the_product(self, bt, dt):
        plan = gr.probe_plan("mxu", bt, dt)
        assert plan["blocks"] == (bt // 64) * (dt // 256)
        assert plan["scratch"] == (dt // 256) * bt * gr.MXU_N

    def test_probe_plan_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown"):
            gr.probe_plan("nope")

    def test_mxu_kernel_order_matches_pallas(self):
        """The mxu kernel's decomposition, emulated in f32 on the CPU: each
        (64-row strip, 256-deep slice) block sums its 64-deep chunks in
        order, each chunk's passes, each pass's four 16-deep k-steps; the
        slices' partial products are then added in slice order.  Held
        against the Pallas kernel at (128, 512) x 3 (two strips, two
        slices)."""
        bt, dt, reps = 128, 512, 3
        rng = np.random.default_rng(12)
        x = rng.standard_normal((bt, dt)).astype(np.float32)
        w = rng.standard_normal((dt, 128)).astype(np.float32)
        f = pl.pallas_call(
            roof2._kern_mxu,
            grid=(reps,),
            in_specs=[
                pl.BlockSpec((bt, dt), lambda t: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((dt, 128), lambda t: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((bt, 128), lambda t: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((bt, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((bt, 128), jnp.float32)],
            interpret=_interpret(),
        )
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(w)))
        xb = torch.from_numpy(x).to(torch.bfloat16).float()
        wb = torch.from_numpy(w).to(torch.bfloat16).float()
        out = torch.zeros(bt, 128)
        for k0 in range(0, dt, 256):
            part = torch.zeros(bt, 128)
            for c in range(k0, k0 + 256, 64):
                for _ in range(reps):
                    for k in range(c, c + 64, 16):
                        part += xb[:, k:k + 16] @ wb[k:k + 16]
            out += part
        assert _rel(out.numpy(), want.astype(np.float64)) <= 1e-5
        assert _rel(ops.roofline_mxu(torch.from_numpy(x), torch.from_numpy(w), reps=reps).numpy(),
                    out.numpy().astype(np.float64)) <= 1e-5

    def test_work_counts(self):
        """The work at the published tile."""
        mxu = gr.roofline_work("mxu")
        assert mxu["bf16_flops"] == 2 * 256 * 8192 * 128 * 64
        const = gr.roofline_work("const")
        assert const["f32_flops"] == 2 * 256 * 8192 * 64
        assert const["bytes"] == 256 * 8192 * 4 + 8192 * 4 + 256 * 4
        assert gr.roofline_work("full")["int_ops"] == 2 * gr.roofline_work("fwd")["int_ops"]
        with pytest.raises(ValueError, match="unknown"):
            gr.roofline_work("nope")


# --- the experiment scripts on the CPU --------------------------------------------------
class TestExperimentScripts:
    @pytest.fixture
    def small_experiments(self, monkeypatch):
        from distlr_tpu_torch.benchmarks import exp_gen_roofline, exp_gen_roofline2

        for mod in (exp_gen_roofline, exp_gen_roofline2):
            monkeypatch.setattr(mod, "BT", 64)
            monkeypatch.setattr(mod, "DT", 256)
            monkeypatch.setattr(mod, "REPS", 2)
        return exp_gen_roofline, exp_gen_roofline2

    def test_cpu_runs_print_the_published_lines(self, small_experiments, capsys):
        roof, roof2 = small_experiments
        assert roof.main(["--device", "cpu"]) == 0
        assert roof2.main(["--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == lines[5] == roof.header(torch.device("cpu"))
        assert "not a device measurement" in lines[0]
        labels = ["A gen-only:        ", "B gen+fwd:         ", "C full fwd+bwd:    ",
                  "   implied samples/sec at D=1M: ", None,
                  "D iota-hash + fwd : ", "E const tile + fwd: ", "F const tile + MXU: "]
        for line, label in zip(lines, [None] + labels):
            if label is not None:
                assert line.startswith(label), line
        assert lines[1].endswith(" G elem/s") and lines[3].endswith(" G gen-elem/s")
        assert float(lines[1].split()[-3]) >= 0

    def test_probe_timer_refuses_without_the_card(self, capsys):
        from distlr_tpu_torch.benchmarks import roofline_probes

        if torch.cuda.is_available():
            pytest.skip("a card is present; this checks the refusal without one")
        assert roofline_probes.main(["--kernels", "const,mxu", "--reps", "1,64"]) == 2
        assert "needs the card" in capsys.readouterr().err

    def test_default_device_is_the_card(self):
        from distlr_tpu_torch.benchmarks import exp_gen_roofline

        if torch.cuda.is_available():
            pytest.skip("a card is present; this checks the refusal without one")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp_gen_roofline.main([])
