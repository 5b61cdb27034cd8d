"""Fig. 6 on the card: the interleave ratio α per kernel type, and Fig. 14's
throughput gains (Eqs. 9–10) at the measured α.

Counterpart of ``benchmarks/fig6_interleave.py``, which times its four
``_workloads`` on the host, where no two share an SM, and otherwise takes
the paper's 1080Ti table.  Here α is measured (``kernels.interleave_probe``):
each kernel type's probe pinned to m SMs, a lane's time with two
co-resident lanes per SM over its time alone, on 16 SMs and on all of them
(:data:`SM_COUNTS`).  The measured α then goes through the port's copy of
``core/interleave.py`` (``throughput_gain_used``, ``throughput_gain_total``)
beside the paper table's gains, in the JAX benchmark's rows.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.core import (INTERLEAVE_RATIO_MAX, throughput_gain_total,
                              throughput_gain_used)

__all__ = ["SM_COUNTS", "gain_rows", "alpha_rows", "measure"]

SM_COUNTS = (16, None)   # 16 SMs, and all of the card's (None)


def gain_rows(alphas: Mapping[str, float], prefix: str = "fig14") -> list:
    """Eq. 10's gain per kernel type on one SM, Eq. 9's on the JAX
    benchmark's mixed set (five tasks of 2 SMs on 10: the four types, then
    the first again), and the least and largest of the per-type gains."""
    rows = [(f"{prefix}_gain_used_{name}", throughput_gain_used([1], [a]))
            for name, a in alphas.items()]
    values = list(alphas.values())
    mixed = (values * 2)[:5]
    rows.append((f"{prefix}_gain_total_5tasks", throughput_gain_total([2] * 5, mixed, 10)))
    gains = [throughput_gain_used([1], [a]) for a in values]
    rows += [(f"{prefix}_gain_min", min(gains)), (f"{prefix}_gain_max", max(gains))]
    return rows


def alpha_rows(measured: Mapping[int, Mapping[str, dict]], n_sms: int) -> list:
    """The rows from ``measured`` ({m: {kind: measure_alpha's dict}}), on a
    card of ``n_sms`` SMs: the JAX benchmark's (``fig6_host_alpha_*`` is
    the card's α on all its SMs; the paper table and its gains), then the
    port's own (α, the makespan ratio and each arrangement's lane time per
    SM count, and the gains at the measured α on all SMs)."""
    card = {kind: r["alpha"] for kind, r in measured[n_sms].items()}
    rows = [(f"fig6_host_alpha_{kind}", a) for kind, a in card.items()]
    for name, alpha in INTERLEAVE_RATIO_MAX.items():
        rows.append((f"fig6_paper_alpha_{name}", alpha))
    rows += gain_rows(INTERLEAVE_RATIO_MAX)
    for m, per in measured.items():
        for kind, r in per.items():
            rows += [(f"fig6_alpha_sms{m}_{kind}", r["alpha"]),
                     (f"fig6_makespan_alpha_sms{m}_{kind}", r["makespan_alpha"]),
                     (f"fig6_lane_us_alone_sms{m}_{kind}", r["alone_us"]),
                     (f"fig6_lane_us_both_sms{m}_{kind}", r["both_us"]),
                     (f"fig6_overlap_sms{m}_{kind}", r["overlap"])]
    rows += gain_rows(card, "fig14_measured")
    return rows


def measure(n_sms: int) -> dict:
    """{m: {kind: measure_alpha(kind, m)}} for m in SM_COUNTS (card only)."""
    from repro_torch.kernels.interleave_probe import KINDS, measure_alpha

    return {m: {kind: measure_alpha(kind, m) for kind in KINDS}
            for m in (c or n_sms for c in SM_COUNTS)}
