#!/usr/bin/env python3
"""Device spans and rests of one served shape's whole jobs, after what may set their level.

    python3 scripts/host_regimes.py [--jobs 40] [--gn 49] [--profiled 20]

On one H100: serves full-width qwen3-0.6b (random weights, seed 0; batch
4, 256-token prompts, 16 greedy tokens) with its steps' graphs captured
on ``--gn`` SMs, and times whole jobs on them as the calibration does
(``ServingEngine.timed_job``: the wall, the prefill's and each decode
step's device span by CUDA events, and the rest, the wall less the
spans), ``--jobs`` a run, each run after one of:

0. the engine's capture on GN (``StepGraph``: the steps' eager warm-up on
   a side stream, then the capture);
1. the steps' eager warm-up on a side stream on 33 SMs, as ``StepGraph``
   runs it, with no capture;
2. a capture on the jobs' own stream: a stream of its own takes the
   warm-up, the capture on GN and then the run's jobs;
3. the engine's capture on 33 SMs, then 5 s idle;
4. the side-stream warm-up on 33 SMs, then 5 s idle.

Each run prints every job's device span and rest, how many jobs ran slow
(device span more than 3 ms above the least of all runs) and what
``nvidia-smi`` read every 100 ms during it (SM and memory clocks, power,
pstate, ``clocks_event_reasons.active``, ``temperature.gpu``).  Then,
after the causes of runs 0, 3 and 4 again, ``--profiled`` jobs a run, in
turns: one with a decode step (the ninth) under the profiler and no
profiler on the rest of the job, one after 50 ms of the card spinning
(``torch.cuda._sleep``), which lets the host queue the job's replays
ahead of the card; each with the host's time in the replay calls.  Of
the profiled jobs it takes the slowest and the fastest by device span,
and prints the ten kernels that add the most ms from the fast job's
profiled step to the slow job's, under their names, how alike every
kernel's slow/fast ratio is, and the idle gaps between the step's device
activities: one kernel that slows sits in the port's code, every kernel
slowing alike belongs to the card's clocks, and kernels that do not slow
while the gaps between them grow put the regime in how the replayed
graph reaches the card; a head start that ends the slow level puts it on
the host.  It writes
``chiprun_out/host_regimes.json`` and ``chiprun_out/host_regimes_smi.csv``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SLOW_MS = 3.0       # a job is slow when its device span exceeds the least by more
PROFILED_STEP = 8   # the decode step profiled inside a job
HEAD_START_CYCLES = 100_000_000  # the card's spin before a job (50 ms at 1980 MHz)
SMI_FIELDS = "timestamp,clocks.sm,clocks.mem,power.draw,pstate,{reasons},temperature.gpu"


def smi_sampler(out: Path) -> tuple[subprocess.Popen, str]:
    """nvidia-smi sampling every 100 ms into ``out``; the reasons field's
    name is ``clocks_event_reasons.active`` where nvidia-smi knows it."""
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        fields = SMI_FIELDS.format(reasons=reasons)
        probe = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
        if probe.returncode == 0:
            break
    proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                             "-lms", "100"], stdout=out.open("w"), stderr=subprocess.DEVNULL)
    return proc, fields


def smi_summary(path: Path, start: datetime.datetime, end: datetime.datetime) -> dict:
    rows = []
    for line in path.read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            when = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
        except (ValueError, IndexError):
            continue
        if start <= when <= end and len(parts) == 7:
            rows.append(parts[1:])
    if not rows:
        return {"samples": 0}

    def number(i):
        return [float(r[i].split()[0]) for r in rows if r[i].split()[0].replace(".", "").isdigit()]

    sm, mem, power, temp = number(0), number(1), number(2), number(5)
    return {"samples": len(rows), "sm_mhz": [min(sm), max(sm)], "mem_mhz": [min(mem), max(mem)],
            "power_w": [min(power), max(power)], "temperature_c": [min(temp), max(temp)],
            "pstates": sorted({r[3] for r in rows}), "event_reasons": sorted({r[4] for r in rows})}


def kernel_us(prof) -> dict:
    """Device µs and launches by kernel name in a profiler window."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            us = us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
            out[e.key] = (us, e.count)
    return out


def device_gaps_us(prof) -> list[float]:
    """The idle gaps between consecutive device activities of a profiler
    window, in µs, in timing order."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    return [max(0.0, b[0] - a[1]) for a, b in zip(spans, spans[1:])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=40)
    ap.add_argument("--gn", type=int, default=49)
    ap.add_argument("--profiled", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("host_regimes.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.graphs import WARMUP

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    smi_csv = out_dir / "host_regimes_smi.csv"
    sampler, fields = smi_sampler(smi_csv)
    print(f"[regimes] nvidia-smi every 100 ms: {fields}")
    try:
        _build.build_all()
        cfg = get_config("qwen3-0.6b")
        engine = ServingEngine(cfg, ServeConfig(max_context=512, batch=4), seed=0)
        prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 256)).astype(np.int32)
        engine.generate(prompt, max_new_tokens=16)
        held, other = (args.gn, 0), (33, 0)

        def recapture(h) -> None:
            """The engine's capture of the steps on ``h``, anew."""
            if (256, h) in engine._graphs:
                engine._drop_graphs([(256, h)])
            engine.capture(256, h)

        def side_warmup() -> None:
            eager = engine.steps(256, other, eager=True)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.inference_mode(), torch.cuda.stream(side):
                for fn in (eager.prefill, eager.decode):
                    for _ in range(WARMUP):
                        fn()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()

        class OwnGraph:
            """A step warmed up and captured on ``stream``, replayed on the
            current stream (the run's jobs make it ``stream`` too)."""

            def __init__(self, fn, stream, pool):
                with torch.inference_mode(), torch.cuda.stream(stream):
                    for _ in range(WARMUP):
                        fn()
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                        fn()
                torch.cuda.synchronize()

            def replay(self):
                self.graph.replay()

        own = {"stream": None}

        def own_stream_capture() -> None:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            eager = engine.steps(256, held, eager=True)
            pool = torch.cuda.graph_pool_handle()
            engine._graphs[256, held] = (OwnGraph(eager.prefill, stream, pool),
                                         OwnGraph(eager.decode, stream, pool))
            own["stream"] = stream

        def idle(cause):
            def run():
                cause()
                time.sleep(5.0)
            return run

        causes = [(f"the engine's capture on {args.gn} SMs", lambda: recapture(held)),
                  ("a side-stream eager warm-up on 33 SMs", side_warmup),
                  (f"a capture on {args.gn} SMs on the jobs' own stream", own_stream_capture),
                  ("the engine's capture on 33 SMs, then 5 s idle", idle(lambda: recapture(other))),
                  ("a side-stream eager warm-up on 33 SMs, then 5 s idle", idle(side_warmup))]

        def timed_jobs(n: int) -> list[dict]:
            stream = own["stream"]
            if stream is None:
                return [engine.timed_job(prompt, 16, held) for _ in range(n)]
            with torch.cuda.stream(stream):
                jobs = [engine.timed_job(prompt, 16, held) for _ in range(n)]
            own["stream"] = None
            recapture(held)   # the engine's own graphs on GN again
            return jobs

        runs = []
        for i, (what, cause) in enumerate(causes):
            t0 = time.perf_counter()
            if cause is not None:
                cause()
            start = datetime.datetime.now()
            jobs = timed_jobs(args.jobs)
            end = datetime.datetime.now()
            span = [j["prefill_span_ms"] + sum(j["step_span_ms"]) for j in jobs]
            runs.append({"what": what, "cause_s": time.perf_counter() - t0, "jobs": jobs,
                         "device_span_ms": span, "rest_ms": [j["rest_ms"] for j in jobs],
                         "start": start, "end": end})
            print(f"[regimes] {i}: after {what}: device span {min(span):.3f}..{max(span):.3f} ms, "
                  f"rest {min(runs[-1]['rest_ms']):.3f}..{max(runs[-1]['rest_ms']):.3f} ms",
                  flush=True)
        least = min(min(r["device_span_ms"]) for r in runs)
        time.sleep(0.5)
        for i, r in enumerate(runs):
            slow = [k for k, s in enumerate(r["device_span_ms"]) if s > least + SLOW_MS]
            r["slow"], r["smi"] = slow, smi_summary(smi_csv, r["start"], r["end"])
            steps = np.array([j["step_span_ms"] for j in r["jobs"]])
            pre = np.array([j["prefill_span_ms"] for j in r["jobs"]])
            print(f"[regimes] {i}: after {r['what']}: {len(slow)} of {len(r['jobs'])} jobs slow "
                  f"(device span over {least:.3f} + {SLOW_MS} ms): {slow}; prefill span "
                  f"{pre.min():.3f}..{pre.max():.3f} ms, a decode step {steps.min():.3f}.."
                  f"{steps.max():.3f} ms; nvidia-smi {r['smi']}")
            print(f"[regimes] {i}: device spans "
                  + " ".join(f"{s:.1f}" for s in r["device_span_ms"]))
            print(f"[regimes] {i}: rests " + " ".join(f"{s:.2f}" for s in r["rest_ms"]))

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

        def profiled_job(head_start: bool) -> dict:
            """One job's steps, each between CUDA events, with the host's
            time in the replay calls; with ``head_start`` the card first
            spins HEAD_START_CYCLES, so the host can queue the job's steps ahead
            of the card; without, the step PROFILED_STEP runs under the
            profiler."""
            steps, st = engine.steps(256, held), engine._static
            events = [torch.cuda.Event(enable_timing=True) for _ in range(34)]
            host, prof = 0.0, None
            with torch.inference_mode():
                st.prompts[256].copy_(torch.as_tensor(prompt))
                torch.cuda.synchronize()
                if head_start:
                    torch.cuda._sleep(HEAD_START_CYCLES)
                for i, step in enumerate([steps.prefill] + [steps.decode] * 16):
                    window = (profile(activities=activities)
                              if not head_start and i == 1 + PROFILED_STEP else None)
                    if window is not None:
                        torch.cuda.synchronize()
                        window.__enter__()
                    events[2 * i].record()
                    t0 = time.perf_counter()
                    step()
                    host += time.perf_counter() - t0
                    events[2 * i + 1].record()
                    if window is not None:
                        torch.cuda.synchronize()
                        window.__exit__(None, None, None)
                        prof = window
                torch.cuda.synchronize()
            spans = [events[2 * j].elapsed_time(events[2 * j + 1]) for j in range(17)]
            out = {"device_span_ms": sum(spans), "host_replay_ms": host * 1e3,
                   "head_start": head_start, "step_ms": spans[1:]}
            if prof is not None:
                out.update(profiled_step_ms=spans[1 + PROFILED_STEP], kernels=kernel_us(prof),
                           gaps_us=device_gaps_us(prof))
            return out

        profiled = []
        for what, cause in (causes[0], causes[3], causes[4]):
            cause()
            jobs = [dict(profiled_job(k % 2 == 1), after=what) for k in range(args.profiled)]
            profiled += jobs
            for head in (False, True):
                some = [j for j in jobs if j["head_start"] == head]
                print(f"[regimes] {len(some)} jobs after {what}, "
                      + (f"each after {HEAD_START_CYCLES} cycles of the card spinning (the host "
                         f"queues ahead)" if head else f"step {PROFILED_STEP} profiled")
                      + ": device spans " + " ".join(f"{j['device_span_ms']:.1f}" for j in some)
                      + "; the host in replay calls " + " ".join(
                          f"{j['host_replay_ms']:.1f}" for j in some) + " ms", flush=True)
        profiled_only = [j for j in profiled if "kernels" in j]
        slow = max(profiled_only, key=lambda j: j["device_span_ms"])
        fast = min(profiled_only, key=lambda j: j["device_span_ms"])
        apart = slow["device_span_ms"] > fast["device_span_ms"] + SLOW_MS
        print(f"[regimes] slowest profiled job {slow['device_span_ms']:.3f} ms (its step "
              f"{slow['profiled_step_ms']:.4f} ms, after {slow['after']}), fastest "
              f"{fast['device_span_ms']:.3f} ms (step {fast['profiled_step_ms']:.4f} ms, after "
              f"{fast['after']}): {'a slow and a fast job' if apart else 'no slow job among them'}")
        names = set(slow["kernels"]) | set(fast["kernels"])
        table = []
        for name in names:
            s_us, s_n = slow["kernels"].get(name, (0.0, 0))
            f_us, f_n = fast["kernels"].get(name, (0.0, 0))
            table.append((name, f_us / 1e3, s_us / 1e3, (s_us - f_us) / 1e3, s_n, f_n))
        table.sort(key=lambda r: -r[3])
        f_total = sum(r[1] for r in table)
        s_total = sum(r[2] for r in table)
        print(f"[regimes] the profiled step's device time: fast {f_total:.4f} ms, slow "
              f"{s_total:.4f} ms (x{s_total / f_total:.4f}), {len(table)} kernel names")
        for name, f_ms, s_ms, add, s_n, f_n in table[:10]:
            ratio = s_ms / f_ms if f_ms else float("inf")
            print(f"[regimes] added {add * 1e3:8.2f} us: {name[:90]}: fast {f_ms * 1e3:.2f} us "
                  f"({f_n} launches), slow {s_ms * 1e3:.2f} us ({s_n}), x{ratio:.3f}")
        big = [r for r in table if r[1] >= 0.01 * f_total]
        ratios = [r[2] / r[1] for r in big]
        added = s_total - f_total
        print(f"[regimes] the {len(big)} kernels holding 1% or more of the fast step: slow/fast "
              f"ratio median {statistics.median(ratios):.4f}, "
              f"{min(ratios):.4f}..{max(ratios):.4f}; "
              f"the largest adds {table[0][3] / added if added else 0:.3f} of the added "
              f"{added:.4f} ms")
        for label, job in (("fast", fast), ("slow", slow)):
            gaps = np.array(job["gaps_us"])
            print(f"[regimes] the {label} job's profiled step: {len(gaps) + 1} device activities, "
                  f"kernel time {sum(us for us, _ in job['kernels'].values()) / 1e3:.4f} ms, idle "
                  f"gaps between them {gaps.sum() / 1e3:.4f} ms (median {np.median(gaps):.2f} us, "
                  f"p90 {np.percentile(gaps, 90):.2f}, p99 {np.percentile(gaps, 99):.2f}, largest "
                  f"{gaps.max():.2f})")
        for r in runs:
            r["start"], r["end"] = r["start"].isoformat(), r["end"].isoformat()
        (out_dir / "host_regimes.json").write_text(json.dumps({
            "nvidia_smi": smi, "gn": args.gn, "smi_fields": fields, "runs": runs,
            "profiled": [{k: v for k, v in j.items() if k not in ("kernels", "gaps_us")}
                         for j in profiled],
            "slow_kernels": slow["kernels"], "fast_kernels": fast["kernels"],
            "kernel_table": table}, indent=1))
        return 0
    finally:
        sampler.terminate()
        sampler.wait(timeout=10)


if __name__ == "__main__":
    sys.exit(main())
