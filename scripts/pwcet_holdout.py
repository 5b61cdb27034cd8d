#!/usr/bin/env python3
"""Held-out check of the probabilistic WCET that a served job's R̂ rests on.

    python3 scripts/pwcet_holdout.py [--src DIR] [--jobs 100] [--out NAME]

On one H100: serves full-width qwen3-0.6b (random weights, seed 0; batch
4, 256-token prompts, 16 greedy tokens, ``max_context`` 512), calibrates
it once as ``chip_smoke.py``'s rt phase does (``ServingEngine.calibrate``:
whole jobs at each of five SM counts, whose host parts give the host
bound, ``task_spec.pwcet_ms`` per count), sets the deadline to the job's R̂ on a third of
the card's SMs and the period to twice that, admits the service on a port
``AdmissionController`` over the card, and runs ``--jobs`` jobs of the
admitted service under the port's ``WallClockExecutor``: jobs the
calibration never saw, with the collector live and no tracing, as a
service runs.  It prints each count the pWCET model makes a claim about:

* the jobs whose response R exceeds the certified R̂, and the largest R / R̂;
* the jobs whose wall (the job's own ``generate``, host clock) exceeds the
  pWCET, the largest wall / pWCET, and the binomial probability of at
  least that many exceedances in that many jobs at ``PWCET_EXCEEDANCE``
  (10⁻³) a job;
* the jobs whose host part (the wall less the calibration's lower bound
  of a job's device part on GN, ``DecodeCalibration.device_lower_ms``: the
  smallest prefill wall and 16 smallest device-busy decode steps measured
  there) exceeds the host bound (the
  largest SM count's pWCET of the calibration jobs' host parts,
  ``DecodeCalibration.host_bound_ms``), the largest host part / bound, and
  the binomial probability of that many at ``PWCET_EXCEEDANCE`` a job;
* the independence of the held-out walls and host parts in timing order,
  which the fits assume (lag-1 autocorrelation and a runs test above and
  below the median), beside the same for the calibration's walls.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), e.g. that of a ``git archive`` of another
commit unpacked under the gitignored ``tmp/``.  The pooled pWCET of the
walls, the host model and the independence statistics are this
checkout's (``task_spec``), applied to the measured tree's calibration,
so every tree is judged by the same rules.  It writes
``chiprun_out/NAME.json``.  The counting functions at the top need only
numpy.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, NEW_TOKENS, MAX_CONTEXT = 4, 256, 16, 512


def binomial_tail(k: int, n: int, p: float) -> float:
    """P(X >= k) for X ~ Binomial(n, p)."""
    return min(1.0, sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i) for i in range(k, n + 1)))


def summarize(responses, r_hat: float, walls, pwcet: float, exceedance: float) -> dict:
    """What the held-out jobs say of R̂ and of the pWCET."""
    over_r = [i for i, r in enumerate(responses) if r > r_hat]
    over_w = [i for i, w in enumerate(walls) if w > pwcet]
    return {"jobs": len(walls), "over_r_hat": over_r, "over_pwcet": over_w,
            "max_r_over_r_hat": max(responses) / r_hat, "max_wall_over_pwcet": max(walls) / pwcet,
            "p_at_least_as_many_over_pwcet": binomial_tail(len(over_w), len(walls), exceedance)}


def summarize_host(walls, device_lower: float, host_bound: float, exceedance: float) -> dict:
    """What the held-out jobs say of the host bound: each job's host part
    (its wall less ``device_lower``), those over ``host_bound``, and the
    binomial probability of at least that many at ``exceedance`` a job."""
    host = [w - device_lower for w in walls]
    over = [i for i, h in enumerate(host) if h > host_bound]
    return {"host_ms": host, "over_host_bound": over,
            "max_host_over_bound": max(host) / host_bound,
            "p_at_least_as_many_over_host_bound": binomial_tail(len(over), len(host), exceedance)}


def checkout_task_spec():
    """This checkout's ``repro_torch.runtime.task_spec``, loaded from its
    file (its own imports resolve in the ``repro_torch`` that ``--src`` put
    first), so every measured tree is judged by the same statistics."""
    path = ROOT / "src" / "repro_torch" / "runtime" / "task_spec.py"
    spec = importlib.util.spec_from_file_location("_checkout_task_spec", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--jobs", type=int, default=100)
    ap.add_argument("--out", default="pwcet_holdout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("pwcet_holdout.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime import AdmissionController, ServingTaskSpec, WallClockExecutor
    from repro_torch.runtime.task_spec import PWCET_EXCEEDANCE, job_response_ms
    from repro_torch.sched import EventTrace
    from repro_torch.serving import ServeConfig, ServingEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"[holdout] repro_torch from {args.src}")
    t0 = time.perf_counter()
    _build.build_all()
    cfg = get_config("qwen3-0.6b")
    engine = ServingEngine(cfg, ServeConfig(max_context=MAX_CONTEXT, batch=BATCH), seed=0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    engine.generate(prompt, max_new_tokens=NEW_TOKENS)  # untimed: first calls' set-up
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = f"chat-{cfg.name}"
    spec = ServingTaskSpec(name=name, arch_id=cfg.name, period_ms=2e9, deadline_ms=1e9,
                           batch=BATCH, seq_len=PROMPT, new_tokens=NEW_TOKENS,
                           dominant="memory_s", vocab=cfg.vocab)
    cal = engine.calibrate(spec)
    deadline = math.ceil(job_response_ms(cal.task(spec), n_sms // 3) * 1e3) / 1e3
    spec = dataclasses.replace(spec, deadline_ms=deadline, period_ms=2 * deadline)
    ac = AdmissionController(gn_total=n_sms)
    dec = engine.rt_register(ac, spec)
    if not dec.admitted:
        print(f"pwcet_holdout.py: not admitted ({dec.reason})", file=sys.stderr)
        return 1
    r_hat, gn = engine.rt_bound
    checkout = checkout_task_spec()
    pwcet = checkout.pwcet_ms(cal.job_ms)
    model = checkout.DecodeCalibration(cal.batch, cal.seq_len, cal.new_tokens, cal.measured)
    host_bound, device_lower = model.host_bound_ms(), model.device_lower_ms(gn)
    print(f"[holdout] calibration: {len(cal.job_ms)} job walls {min(cal.job_ms):.3f}.."
          f"{max(cal.job_ms):.3f} ms, pooled pWCET {pwcet:.3f} ms; host bound "
          f"{host_bound:.3f} ms (per SM count " + ", ".join(
              f"{m}: {v:.3f}" for m, v in model.host_pwcets_ms().items())
          + f"); admitted on GN={gn}, R^ {r_hat:.3f} ms, D {deadline:.3f} ms, period "
          f"{spec.period_ms:.3f} ms; a job's device part on GN at least {device_lower:.3f} ms "
          f"({time.perf_counter() - t0:.1f} s)")

    walls, generate = [], engine.generate

    def timed(*a, **kw):
        t1 = time.perf_counter()
        out = generate(*a, **kw)
        walls.append((time.perf_counter() - t1) * 1e3)
        return out

    engine.generate = timed
    trace = EventTrace(us_per_unit=1e6, label=name)
    executor = WallClockExecutor([engine.rt_service(spec, prompt)], trace=trace)
    t1 = time.perf_counter()
    stats = executor.run((args.jobs - 0.5) * spec.period_ms / 1e3)[name]
    run_s = time.perf_counter() - t1
    responses = [dict(e.meta)["response_s"] * 1e3 for e in trace.events if e.kind == "complete"]
    summary = summarize(responses, r_hat, walls, pwcet, PWCET_EXCEEDANCE)
    host = summary["host"] = summarize_host(walls, device_lower, host_bound, PWCET_EXCEEDANCE)
    independence = checkout.independence
    ind = summary["independence"] = independence(walls)
    host_ind = summary["host_independence"] = independence(host["host_ms"])
    cal_ind = independence(cal.job_ms)
    print(f"[holdout] {len(walls)} held-out jobs in {run_s:.1f} s (released {stats['released']}, "
          f"missed {stats['missed']}): walls {min(walls):.3f}..{max(walls):.3f} ms, R "
          f"{min(responses):.3f}..{max(responses):.3f} ms")
    print(f"[holdout] R > R^ {r_hat:.3f} ms: {len(summary['over_r_hat'])} jobs "
          f"{summary['over_r_hat']}; largest R/R^ {summary['max_r_over_r_hat']:.4f}")
    print(f"[holdout] wall > pWCET {pwcet:.3f} ms: {len(summary['over_pwcet'])} jobs "
          f"{summary['over_pwcet']}; largest wall/pWCET {summary['max_wall_over_pwcet']:.4f}; "
          f"P(at least {len(summary['over_pwcet'])} of {len(walls)} at {PWCET_EXCEEDANCE:g} a "
          f"job) {summary['p_at_least_as_many_over_pwcet']:.3g}")
    print(f"[holdout] host part > host bound {host_bound:.3f} ms: "
          f"{len(host['over_host_bound'])} jobs {host['over_host_bound']}; host parts "
          f"{min(host['host_ms']):.3f}..{max(host['host_ms']):.3f} ms, largest host part/bound "
          f"{host['max_host_over_bound']:.4f}; P(at least {len(host['over_host_bound'])} of "
          f"{len(walls)} at {PWCET_EXCEEDANCE:g} a job) "
          f"{host['p_at_least_as_many_over_host_bound']:.3g}")
    for what, s in (("held-out", ind), ("held-out host part", host_ind),
                    ("calibration", cal_ind)):
        print(f"[holdout] independence of the {what} walls in timing order: lag-1 "
              f"autocorrelation {s['lag1']:.4f}; runs above/below the median {s['runs']} against "
              f"{s['expected']:.1f} expected, z {s['z']:.3f}, p {s['p']:.3g}")
    out = ROOT / "chiprun_out" / f"{args.out}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({
        "nvidia_smi": smi, "src": args.src, "gn": gn, "r_hat_ms": r_hat, "deadline_ms": deadline,
        "period_ms": spec.period_ms, "pwcet_ms": pwcet, "calibration_job_ms": list(cal.job_ms),
        "host_bound_ms": host_bound, "host_pwcets_ms": model.host_pwcets_ms(),
        "device_lower_on_gn_ms": device_lower,
        "calibration_independence": cal_ind, "walls_ms": walls, "responses_ms": responses,
        "executor": stats, "summary": summary, "seconds": time.perf_counter() - t0}, indent=1))
    print(f"[holdout] done in {time.perf_counter() - t0:.1f} s; {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
