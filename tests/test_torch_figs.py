"""The port's Fig. 4 and Fig. 6 runners, on the CPU.

Fig. 4: Eq. 3's fit recovers an exact C and L from a synthetic t(m), and
the rows keep the JAX benchmark's names (``benchmarks/fig4_kernel_scaling.py``)
and values' meaning.  Fig. 6: the gains of Eqs. 9–10 at any α equal the
reference's (``repro.core.interleave``), which holds the port's copy of it,
and the rows keep the JAX benchmark's names (``benchmarks/fig6_interleave.py``)
beside the port's own.  The measurements themselves run on the card only.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import interleave as ref

from repro_torch.benchmarks import fig4_kernel_scaling as fig4
from repro_torch.benchmarks import fig6_interleave as fig6
from repro_torch.core import INTERLEAVE_RATIO_MAX

BANDS = list(range(1, 133))
# the JAX benchmarks' row names
FIG4_ROWS = {"fig4_eq3_fit_r2", "fig4_per_tile_us", "fig4_t_bands1_us", "fig4_t_bands2_us",
             "fig4_t_bands4_us", "fig4_t_bands8_us", "fig4_speedup_8bands"}
FIG6_ROWS = ({f"fig6_host_alpha_{k}" for k in INTERLEAVE_RATIO_MAX}
             | {f"fig6_paper_alpha_{k}" for k in INTERLEAVE_RATIO_MAX}
             | {f"fig14_gain_used_{k}" for k in INTERLEAVE_RATIO_MAX}
             | {"fig14_gain_total_5tasks", "fig14_gain_min", "fig14_gain_max"})
# α as measured on an H100 (compute, memory, branch, special on all SMs)
CARD_LIKE = {"compute": 1.578, "memory": 1.612, "branch": 1.072, "special": 1.522}


@pytest.mark.parametrize("c_us,l_us", [(2503.0, 19.0), (600.0, 10.3), (50.5, 50.0)])
def test_fig4_fit_recovers_an_exact_c_and_l(c_us, l_us):
    t = [(c_us - l_us) / m + l_us for m in BANDS]
    fit = fig4.fit_eq3(BANDS, t)
    assert fit["c"] == pytest.approx(c_us) and fit["l"] == pytest.approx(l_us)
    assert fit["r2"] == pytest.approx(1.0)


def test_fig4_fit_of_a_flat_curve_has_no_r2():
    fit = fig4.fit_eq3(BANDS, [50.0] * len(BANDS))
    assert fit["c"] == pytest.approx(50.0) and fit["l"] == pytest.approx(50.0)
    assert np.isnan(fit["r2"])


def test_fig4_fit_of_a_staircase():
    """t(m) flat where a lane's units do not change (ceil(U / 2m) units of
    10 µs, U = 256, plus 19 µs): the fit still explains most of it."""
    t = [-(-256 // (2 * m)) * 10.0 + 19.0 for m in BANDS]
    fit = fig4.fit_eq3(BANDS, t)
    assert 0.99 < fit["r2"] < 1.0 and 1200 < fit["c"] < 1400 and 10 < fit["l"] < 40


@pytest.mark.parametrize("suffix", list(fig4.SHAPES))
def test_fig4_rows_keep_the_jax_benchmark_names(suffix):
    c_us, l_us, units = 2503.0, 19.0, 256
    t = [(c_us - l_us) / m + l_us for m in BANDS]
    rows = dict(fig4.curve_rows(suffix, BANDS, t, units))
    assert {name + suffix for name in FIG4_ROWS} <= set(rows)
    assert rows[f"fig4_per_tile_us{suffix}"] == pytest.approx(c_us / units)
    assert rows[f"fig4_speedup_8bands{suffix}"] == pytest.approx(t[0] / t[7])
    assert rows[f"fig4_t_bands132_us{suffix}"] == t[-1]
    assert rows[f"fig4_eq3_c_us{suffix}"] == pytest.approx(c_us)
    assert rows[f"fig4_eq3_l_us{suffix}"] == pytest.approx(l_us)


@pytest.mark.parametrize("alphas", [dict(INTERLEAVE_RATIO_MAX), CARD_LIKE,
                                    {"compute": 1.0, "memory": 2.0, "branch": 1.3,
                                     "special": 1.999}])
def test_fig6_gains_equal_the_references_for_the_same_alpha(alphas):
    rows = dict(fig6.gain_rows(alphas, "g"))
    for name, a in alphas.items():
        assert rows[f"g_gain_used_{name}"] == ref.throughput_gain_used([1], [a])
    values = list(alphas.values())
    # the JAX benchmark's mixed set: five tasks of 2 SMs on 10, the types in
    # order, then the first again
    mixed = values[:5] + values[:1]
    assert rows["g_gain_total_5tasks"] == pytest.approx(
        ref.throughput_gain_total([2] * 5, mixed, 10), rel=1e-15)
    gains = [ref.throughput_gain_used([1], [a]) for a in values]
    assert (rows["g_gain_min"], rows["g_gain_max"]) == (min(gains), max(gains))


def test_fig6_rows_keep_the_jax_benchmark_names():
    measured = {m: {k: {"alpha": a + m / 1e4, "alone_us": 100.0, "both_us": 100.0 * a,
                        "makespan_alpha": 2.0, "overlap": 0.99} for k, a in CARD_LIKE.items()}
                for m in (16, 132)}
    rows = dict(fig6.alpha_rows(measured, 132))
    assert FIG6_ROWS <= set(rows)
    for kind, a in CARD_LIKE.items():
        assert rows[f"fig6_host_alpha_{kind}"] == a + 132 / 1e4
        assert rows[f"fig6_alpha_sms16_{kind}"] == a + 16 / 1e4
        assert rows[f"fig6_makespan_alpha_sms132_{kind}"] == 2.0
        assert rows[f"fig6_paper_alpha_{kind}"] == INTERLEAVE_RATIO_MAX[kind]
        assert rows[f"fig14_measured_gain_used_{kind}"] == pytest.approx(
            2.0 / (a + 132 / 1e4) - 1.0)
    assert rows["fig14_gain_total_5tasks"] == pytest.approx(0.190895, abs=1e-6)
    assert fig6.SM_COUNTS == (16, None)
    assert np.isfinite(list(rows.values())).all()
