"""The port's traffic model against the JAX package's, on the CPU.

:mod:`distlr_tpu_torch.traffic` is the offered-load model fleetsim drives
(simulated arrivals) and a load generator shares: the diurnal curve and
its deterministic send schedule, Zipf popularity (sampling and the
closed-form ``mass`` the reshard-convergence property uses), tenant-mix
parsing and apportionment, and the replayable label-delay distribution.

* the unit table of JAX's ``tests/test_traffic.py``, run on the port;
* on the same seeds and inputs, every function and sampler gives JAX's
  values exactly, and bad input raises JAX's error text.
"""

from __future__ import annotations

import math
import random
import statistics

import pytest

from distlr_tpu import traffic as jax_traffic
from distlr_tpu_torch import traffic
from distlr_tpu_torch.traffic import (
    LabelDelay,
    ZipfSampler,
    parse_tenant_mix,
    qps_at,
    schedule,
    split_by_mix,
)


class TestDiurnalCurve:
    def test_base_at_period_edges_peak_at_half(self):
        assert qps_at(0.0, 10.0, 50.0, 60.0) == pytest.approx(10.0)
        assert qps_at(60.0, 10.0, 50.0, 60.0) == pytest.approx(10.0)
        assert qps_at(30.0, 10.0, 50.0, 60.0) == pytest.approx(50.0)

    def test_curve_is_symmetric_about_the_peak(self):
        for dt in (1.0, 7.0, 13.0):
            assert qps_at(30.0 - dt, 10.0, 50.0, 60.0) == pytest.approx(
                qps_at(30.0 + dt, 10.0, 50.0, 60.0))

    def test_schedule_integrates_the_curve(self):
        """Send count over a whole period ~ the mean qps times the
        duration, offsets non-decreasing, identical on a re-run (no RNG
        in the open-loop schedule)."""
        times = schedule(60.0, 10.0, 50.0, 60.0)
        assert len(times) == pytest.approx((10.0 + 50.0) / 2.0 * 60.0, rel=0.02)
        assert times == sorted(times)
        assert times == schedule(60.0, 10.0, 50.0, 60.0)

    def test_schedule_density_follows_the_curve(self):
        times = schedule(60.0, 10.0, 50.0, 60.0)
        trough = sum(1 for t in times if t < 10.0)
        crest = sum(1 for t in times if 25.0 <= t < 35.0)
        assert crest > 2 * trough


class TestZipfSampler:
    def test_validation_is_loud(self):
        with pytest.raises(ValueError, match="n >= 1"):
            ZipfSampler(0)
        with pytest.raises(ValueError, match="alpha"):
            ZipfSampler(8, alpha=-0.1)

    def test_alpha_zero_is_uniform(self):
        z = ZipfSampler(100, alpha=0.0)
        assert z.mass(0, 25) == pytest.approx(0.25)
        assert z.mass(25, 100) == pytest.approx(0.75)

    def test_mass_is_a_probability(self):
        z = ZipfSampler(64, alpha=1.1)
        assert z.mass(0, 64) == pytest.approx(1.0)
        assert z.mass(10, 10) == 0.0
        assert z.mass(-5, 3) == pytest.approx(z.mass(0, 3))
        assert sum(z.mass(k, k + 1) for k in range(64)) == pytest.approx(1.0)

    def test_head_is_hotter_than_the_tail(self):
        z = ZipfSampler(1 << 14, alpha=1.1)
        assert z.mass(0, 16) > 0.3
        assert z.mass(0, 16) > 100 * z.mass(1 << 13, (1 << 13) + 16)

    def test_samples_match_the_closed_form_mass(self):
        z = ZipfSampler(32, alpha=1.0)
        rng = random.Random(7)
        n = 20_000
        hits = sum(1 for _ in range(n) if z.sample(rng) < 4)
        assert hits / n == pytest.approx(z.mass(0, 4), abs=0.01)

    def test_sampling_is_replayable(self):
        z = ZipfSampler(256, alpha=1.1)
        a = [z.sample(random.Random(3)) for _ in range(200)]
        b = [z.sample(random.Random(3)) for _ in range(200)]
        assert a == b
        assert all(0 <= k < 256 for k in a)


class TestTenantMix:
    def test_parse_normalizes(self):
        mix = parse_tenant_mix("v1=0.8, v2=0.2")
        assert mix == {"v1": pytest.approx(0.8), "v2": pytest.approx(0.2)}
        mix = parse_tenant_mix("a=2,b=6")
        assert mix["a"] == pytest.approx(0.25)
        assert mix["b"] == pytest.approx(0.75)

    def test_parse_accepts_a_ready_mapping(self):
        assert parse_tenant_mix({"m": 3, "n": 1})["m"] == pytest.approx(0.75)

    def test_split_sums_and_is_deterministic(self):
        mix = parse_tenant_mix("a=0.5,b=0.3,c=0.2")
        out = split_by_mix(7, mix)
        assert sum(out.values()) == 7
        assert out == split_by_mix(7, mix)
        assert out["a"] >= 3 and out["b"] >= 2 and out["c"] >= 1

    def test_split_edge_counts(self):
        mix = parse_tenant_mix("a=1,b=1")
        assert sum(split_by_mix(0, mix).values()) == 0
        assert sum(split_by_mix(1, mix).values()) == 1
        with pytest.raises(ValueError, match=">= 0"):
            split_by_mix(-1, mix)


class TestLabelDelay:
    def test_validation_is_loud(self):
        with pytest.raises(ValueError, match="p50_s <= p95_s"):
            LabelDelay(5.0, 2.0)
        with pytest.raises(ValueError, match="p50_s"):
            LabelDelay(0.0, 2.0)

    def test_degenerate_distribution_is_constant(self):
        assert LabelDelay(3.0, 3.0).sample(random.Random(1)) == 3.0

    def test_quantiles_pin_the_lognormal(self):
        d = LabelDelay(2.0, 30.0)
        rng = random.Random(5)
        draws = sorted(d.sample(rng) for _ in range(20_000))
        assert statistics.median(draws) == pytest.approx(2.0, rel=0.05)
        assert draws[int(0.95 * len(draws))] == pytest.approx(30.0, rel=0.10)
        assert all(x > 0 and math.isfinite(x) for x in draws)

    def test_sampling_is_replayable(self):
        d = LabelDelay(2.0, 30.0)
        assert [d.sample(random.Random(9)) for _ in range(3)] == \
            [d.sample(random.Random(9)) for _ in range(3)]


# ---------------------------------------------------------------------------
# the port against the JAX package, same inputs, exact equality
# ---------------------------------------------------------------------------

_CURVES = [(10.0, 50.0, 60.0), (0.5, 3.0, 7.5), (100.0, 100.0, 10.0), (2.0, 40.0, 3600.0)]


class TestEqualsJax:
    @pytest.mark.parametrize("curve", _CURVES)
    def test_qps_at_and_schedule(self, curve):
        base, peak, period = curve
        ts = [i * period / 97.0 for i in range(200)] + [-3.0, 1e6]
        assert [qps_at(t, base, peak, period) for t in ts] == \
            [jax_traffic.qps_at(t, base, peak, period) for t in ts]
        for duration, dt in ((min(period, 60.0), None), (period * 0.37, 0.01)):
            kw = {} if dt is None else {"dt": dt}
            assert schedule(duration, base, peak, period, **kw) == \
                jax_traffic.schedule(duration, base, peak, period, **kw)

    @pytest.mark.parametrize("n,alpha,seed", [(1, 1.1, 0), (32, 0.0, 1), (256, 1.1, 3),
                                              (1 << 14, 1.05, 7), (1000, 2.5, 11)])
    def test_zipf_sample_and_mass(self, n, alpha, seed):
        ours, theirs = ZipfSampler(n, alpha), jax_traffic.ZipfSampler(n, alpha)
        ra, rb = random.Random(seed), random.Random(seed)
        assert [ours.sample(ra) for _ in range(2000)] == [theirs.sample(rb) for _ in range(2000)]
        bounds = [(-5, 3), (0, n), (n // 3, n // 2 + 1), (n - 1, n + 4), (7, 7)]
        assert [ours.mass(lo, hi) for lo, hi in bounds] == \
            [theirs.mass(lo, hi) for lo, hi in bounds]

    @pytest.mark.parametrize("p50,p95,seed", [(2.0, 30.0, 5), (3.0, 3.0, 1), (0.1, 0.5, 9)])
    def test_label_delay_sample(self, p50, p95, seed):
        ra, rb = random.Random(seed), random.Random(seed)
        ours, theirs = LabelDelay(p50, p95), jax_traffic.LabelDelay(p50, p95)
        assert [ours.sample(ra) for _ in range(500)] == [theirs.sample(rb) for _ in range(500)]

    @pytest.mark.parametrize("spec", ["v1=0.8, v2=0.2", "a=2,b=6", "a=0.5,b=0.3,c=0.2",
                                      {"m": 3, "n": 1}, "x=1", " p = 7 ,q=0.25 "])
    def test_tenant_mix_and_split(self, spec):
        mix = parse_tenant_mix(spec)
        assert mix == jax_traffic.parse_tenant_mix(spec)
        for count in (0, 1, 7, 100, 1001):
            assert split_by_mix(count, mix) == jax_traffic.split_by_mix(count, mix)

    @pytest.mark.parametrize("call", [
        ("parse_tenant_mix", ("",)), ("parse_tenant_mix", ("v1=1,v1=2",)),
        ("parse_tenant_mix", ("v1",)), ("parse_tenant_mix", ("v1=lots",)),
        ("parse_tenant_mix", ("v1=0",)), ("parse_tenant_mix", ("v1=-2",)),
        ("parse_tenant_mix", ({},)), ("split_by_mix", (-1, {"a": 1.0})),
        ("ZipfSampler", (0,)), ("ZipfSampler", (8, -0.1)),
        ("LabelDelay", (5.0, 2.0)), ("LabelDelay", (0.0, 2.0)),
    ], ids=lambda c: f"{c[0]}{c[1]!r}")
    def test_bad_input_raises_jax_text(self, call):
        name, args = call
        with pytest.raises(ValueError) as theirs:
            getattr(jax_traffic, name)(*args)
        with pytest.raises(ValueError) as ours:
            getattr(traffic, name)(*args)
        assert str(ours.value) == str(theirs.value)
