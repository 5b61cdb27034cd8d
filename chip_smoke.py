#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the repository root and imports only ``repro_torch`` (from
``src/``).  Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the three hand kernels and the interleave probes with nvcc
   into ``build/``, timed;
   analysis: Algorithm 2 over the card's SMs on Table-1 task sets (N = 5,
   M = 5, utilisations 0.6 and 1.0, seeds 0-2, ``max_nodes`` 100,000),
   with the numpy engine on the host and the torch engine on the card:
   identical decisions and candidates tried, every fixed point within
   1e-9, fixed points run on the card, each engine's candidates/s;
   fig4: the pinned matmul alone on m = 1..all SMs at three shapes (the
   JAX benchmark's, qwen3-0.6b's up-projection at prefill and at decode),
   t(m) and Eq. 3's fit (R^2, C, L, a work unit's time, the speedup at 8
   bands); fig6: alpha of the four kernel types' probes
   (``kernels/csrc/interleave_probe.cu``), two co-resident lanes per SM
   against one, on 16 SMs and on all, and Eqs. 9-10's gains at the
   measured alpha beside the paper table's; each line with the card's
   name and power limit;
3. qwen3-0.6b path:
   a. kernels against their plain PyTorch versions on the card, at the
      path's shapes: persistent_matmul (bf16 and f32, n_bands in {1, 8,
      all SMs}: work-unit coverage, the allocated-SM check, bit-identity
      across band counts; ragged K, N and M, for the wgmma variant also
      from a misaligned operand; each shape's variant named) and
      flash_attention through the route the model takes (``ops.mha_flash``
      on [B, S, H, hd] q and [B, S, Hkv, hd] k/v, one launch of
      ``flash_attention_gqa``) against ``mha_flash_ref``: the prefill
      shape, group ratios 1, 2 and 4, sliding window, ragged S, float32,
      hd 32 and 64, and the [BH, S, hd] entry bit-identical to it; each
      kernel's device time (CUDA-graph replay) beside its plain version,
      a library yardstick and its bound (and GB/s for the M <= 4 matmul),
      and its time when issued eagerly;
   b. main path: full-width qwen3-0.6b in bf16 (random weights from a seed)
      through ``ServingEngine.generate``, its prefill and decode steps
      captured as CUDA graphs first (the capture timed), two rounds of 4
      requests of 256 prompt tokens and 16 greedy tokens as graph replays,
      with the kernels' exact launch counts (a replay adds the launches its
      capture recorded); the replays' tokens equal to the eager path's on
      the same prompts; then the prefill logits against the same model on
      the plain versions (no kernel launches there: every counter is held
      still), both held to a float32 run of the plain versions (one block
      at a time), and each block's own error on either path, reported;
   c. profile: device time by kernel and the device's idle share over one
      prefill and eight decode steps (torch.profiler), replayed and eager,
      with each pinned matmul variant's and the flash variant's launches
      in a prefill held to the shapes' choice;
   d. admission: the steps' graphs captured on five SM counts, then the
      decode step's device-busy time, the prefill's wall and whole jobs'
      walls measured there (graph replays), each job's wall split into its
      prefill's and decode steps' device spans (CUDA events) and the rest,
      the independence of the job walls (lag-1 autocorrelation, runs
      test), t(m) (the largest profiled busy step and job's decode-step
      span, which must cover every job's step) fitted (t(m) <= A/m + L:
      GW = 2A + L, GL = L; the largest prefill, wall or span, goes into the
      first CPU segment), the rests and their independence, each count's
      pWCET of them and the largest, which the decode CPU segments carry,
      beside the earlier rule's (the wall less the smallest prefill wall and
      16 smallest busy steps), the interleave ratio alpha of the step's
      kernel type measured on the card (>= 1) and the job's R^ at it and at
      the paper table's, the job's R^ beside the pooled rule's on the same
      calibration (the new one must be the smaller), the
      task admitted by a port AdmissionController over the card's SMs
      (1 < GN < all), the replays' tokens on GN against the eager path's,
      then rounds through ``generate`` registered: graphs captured with
      every pinned matmul traced on the GN SMs (each replay's units
      checked in the graph), and each decode step's device-busy time held
      to GR^(GN);
   e. engine: the admitted service alone under the port's
      WallClockExecutor for ENGINE_JOBS whole jobs at its period (graphs
      with every pinned matmul traced on the GN SMs), the port's
      BoundMonitor reading each job's R against the certified R^ (no
      bound_violation, no deadline_miss, every R <= R^), and the port's
      simulate over the admitted set with no miss;
4. jamba-v0.1-52b path, at full width cut to one period of 8 layers (the
   32 layers' 102.9 GB of bf16 weights exceed the card's 80 GB), after
   the qwen engine is freed: the same five phases, with selective_scan
   held to its plain version at the prefill chunk's shape (h0 none, zero
   and random; c in f32 and bf16) and at ragged shapes, and the pinned
   matmul checked (at every band count where K is split or the wgmma
   variant runs) and timed at jamba's projection shapes.

Prints a ``{"kernels": [...]}`` line (each kernel's launches and times
summed over both paths) and, last, ``{"ok": true, ...}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

BATCH, PROMPT, NEW_TOKENS, ROUNDS, MAX_CONTEXT = 4, 256, 16, 2, 512
SCAN_CHUNK = 128  # the Mamba prefill's time chunk (models.mamba.ssm_scan_chunked)
SEED = 0
# Tolerances, kernel vs plain version on the same inputs:
MATMUL_F32_TOL = 1e-4    # abs, outputs of unit scale; both accumulate in f32 (no TF32)
MATMUL_BF16_TOL = 1e-2   # rtol = atol: one bf16 ulp (<= 2**-7 relative) from f32 sums
FLASH_F32_TOL = 2e-4     # as tests/test_kernels.py for f32 attention
FLASH_BF16_TOL = 3e-2    # as tests/test_kernels.py for bf16 attention
SCAN_TOL = 1e-4          # rtol = atol, as tests/test_kernels.py: the same f32 FMAs
                         # in the same t order; only the sum over N differs
# Prefill logits of the bf16 model: the kernel path may differ from the
# plain path, and from a float32 run of the plain path, by at most this
# many times the plain bf16 path's own relative L2 error against that run.
LOGITS_NOISE_FACTOR = 2.0
ENGINE_JOBS = 4      # whole jobs each cell's service runs under the executor
SIM_PERIODS = 20     # the simulator's horizon, in periods of the service
# Algorithm 2 as a user admitting services onto the card runs it: Table-1
# task sets of N tasks of M subtasks, over every SM of the card
ANALYSIS_SETS = [(util, seed) for util in (0.6, 1.0) for seed in range(3)]
ANALYSIS_TASKS, ANALYSIS_SUBTASKS, ANALYSIS_NODES = 5, 5, 100_000
ANALYSIS_TOL = 1e-9      # every fixed point's R^, torch engine against the numpy engine


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _events_ms(run, count: int) -> float:
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn: ``iters`` calls captured into one CUDA
    graph, replayed ``reps`` times between CUDA events.  A replay does no
    host work, so a small kernel is timed without its launch's host cost."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def replays():
        for _ in range(reps):
            graph.replay()

    ms = _events_ms(replays, reps * iters)
    del graph
    return ms


def eager_ms(fn, iters: int = 20) -> float:
    """Time of one call of fn issued back to back from the host (CUDA
    events): the host's issue cost where it exceeds the device time."""
    for _ in range(3):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    return _events_ms(calls, iters)


def cycling(fn, args_list):
    """fn over a ring of argument tuples (weights beyond the 50 MB L2)."""
    state = {"i": 0}

    def call():
        args = args_list[state["i"] % len(args_list)]
        state["i"] += 1
        return fn(*args)

    return call


def bound(n_bytes: float, flops: float, f32: bool = False) -> dict:
    """Least time for the work: bytes over the HBM rate or FLOPs over the
    peak for their type (bf16 tensor cores, or float32 outside them),
    whichever is larger (H100 SXM data sheet)."""
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32

    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = flops / (PEAK_FLOPS_F32 if f32 else PEAK_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel call of the model path goes to its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref, mha_flash_ref, selective_scan_ref

    with mock.patch.object(ops, "persistent_matmul", lambda x, w, *_: matmul_ref(x, w)), \
            mock.patch.object(ops, "flash_attention_gqa", mha_flash_ref), \
            mock.patch.object(ops, "selective_scan", selective_scan_ref):
        yield


# ------------------------------------------------------- the path's shapes


def scan_chunks() -> tuple[int, int]:
    """(chunk, chunks) of one Mamba prefill of PROMPT steps."""
    return (SCAN_CHUNK, PROMPT // SCAN_CHUNK) if PROMPT % SCAN_CHUNK == 0 else (PROMPT, 1)


def layers(cfg):
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def matmul_calls(cfg) -> dict:
    """(M, K, N, dtype) -> launches of the pinned matmul on the main path
    (ROUNDS prefills of BATCH x PROMPT tokens, NEW_TOKENS decode steps
    each), from the layer list: attention q/k/v/o; Mamba in_proj, x_proj
    (once per time chunk) and out_proj; MLP gate/up/down; the MoE router in
    float32.  The lm head and the MoE experts are plain products."""
    d, hd, ff, di = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.d_inner
    q, kv, ds = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.mamba_d_state
    chunk, n_chunks = scan_chunks()
    calls = collections.Counter()
    for m, xm, xn, times in ((BATCH * PROMPT, BATCH * chunk, n_chunks, ROUNDS),
                             (BATCH, BATCH, 1, ROUNDS * NEW_TOKENS)):
        for spec in layers(cfg):
            if spec.mixer == "attn":
                shapes = [(m, d, q), (m, d, kv), (m, d, kv), (m, q, d)]
            else:
                shapes = [(m, d, 2 * di)] + [(xm, di, 2 * ds + 1)] * xn + [(m, di, d)]
            if spec.ffn == "mlp":
                shapes += [(m, d, ff), (m, d, ff), (m, ff, d)]
            for shape in shapes:
                calls[(*shape, cfg.dtype)] += times
            if spec.ffn == "moe":
                calls[(m, d, cfg.n_experts, "float32")] += times
    return dict(calls)


def prefill_kernels(cfg) -> dict:
    """The pinned matmul's and flash attention's launches in one prefill, by
    the CUDA kernel each shape takes."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.persistent_matmul import kernel_name

    chunk, _ = scan_chunks()
    out = collections.Counter()
    for (m, k, n, dt), calls in matmul_calls(cfg).items():
        if m in (BATCH * PROMPT, BATCH * chunk):
            out[kernel_name(m, k, n, getattr(torch, dt))] += calls // ROUNDS
    n_attn = expected_launches(cfg)["flash_attention"] // ROUNDS
    if n_attn:
        out[flash_attention.kernel_name(getattr(torch, cfg.dtype), cfg.head_dim)] += n_attn
    return dict(out)


def expected_launches(cfg) -> dict:
    n_attn = sum(spec.mixer == "attn" for spec in layers(cfg))
    n_mamba = sum(spec.mixer == "mamba" for spec in layers(cfg))
    return {"persistent_matmul": sum(matmul_calls(cfg).values()),
            "flash_attention": n_attn * ROUNDS,
            "selective_scan": n_mamba * scan_chunks()[1] * ROUNDS}


# --------------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0])
    props = torch.cuda.get_device_properties(0)
    print(f"[device] {torch.cuda.get_device_name(0)}: {props.multi_processor_count} SMs, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"nvidia_smi": smi[0], "sms": props.multi_processor_count}


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    print(f"[build] {sorted(logs)} in {seconds:.1f} s")
    for name, log in logs.items():
        kernel = "?"  # ptxas names the function, then gives its registers and spills
        for line in log.splitlines():
            found = re.search(r"Function properties for \S*?\d((?:pinned|flash|scan|sm|probe)"
                              r"[a-z0-9_]*_kernel)", line)
            if found:
                kernel = found.group(1)
            if "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}")
    return {"seconds": seconds, "nvcc": logs}


def phase_fig4(smi: str) -> dict:
    """Fig. 4 on the card (``repro_torch.benchmarks.fig4_kernel_scaling``):
    the pinned matmul alone on m = 1..all SMs at its three shapes, t(m) and
    Eq. 3's fit t = (C - L)/m + L for each.  Fails on a time that is not
    finite and positive or a fit that explains nothing."""
    from repro_torch.benchmarks import fig4_kernel_scaling as fig4

    t0 = time.perf_counter()
    bands, out = fig4.bands_of_card(), {}
    for suffix, shape in fig4.SHAPES.items():
        label = suffix.lstrip("_") or "jax_benchmark"
        t_us, rows = fig4.shape_curve(suffix, bands)
        rows = dict(rows)
        fit = {key: rows[f"fig4_{key}{suffix}"] for key in
               ("eq3_fit_r2", "eq3_c_us", "eq3_l_us", "per_tile_us", "speedup_8bands")}
        check(all(math.isfinite(v) and v > 0 for v in t_us), f"[fig4] {label}: t(m) {t_us}")
        check(0 < fit["eq3_fit_r2"] <= 1, f"[fig4] {label}: Eq. 3 fit R^2 {fit['eq3_fit_r2']}")
        print(f"[fig4] ({smi}) {label} {shape}: t(m) us for m = 1..{bands[-1]}: "
              + " ".join(f"{t:.2f}" for t in t_us))
        print(f"[fig4] ({smi}) {label}: Eq. 3 fit R^2 {fit['eq3_fit_r2']:.6f}, C "
              f"{fit['eq3_c_us']:.3f} us, L {fit['eq3_l_us']:.3f} us; per work unit "
              f"{fit['per_tile_us']:.4f} us; speedup at 8 bands {fit['speedup_8bands']:.4f}")
        out[label] = {"shape": shape, "t_us": t_us, "rows": rows}
    seconds = time.perf_counter() - t0
    print(f"[fig4] ({smi}) {len(bands)} band counts at {len(out)} shapes in {seconds:.1f} s")
    return {"shapes": out, "seconds": seconds}


def phase_fig6(smi: str, n_sms: int) -> dict:
    """Fig. 6 on the card (``repro_torch.benchmarks.fig6_interleave``): α of
    each kernel type's probe, two co-resident lanes per SM against one, on
    16 SMs and on all; the two lanes of every SM must have overlapped for
    90% of the shorter one.  Then Eqs. 9-10's gains at the measured α
    beside the paper table's."""
    from repro_torch.benchmarks import fig6_interleave as fig6

    t0 = time.perf_counter()
    measured = fig6.measure(n_sms)
    rows = dict(fig6.alpha_rows(measured, n_sms))
    for m, per in measured.items():
        for kind, r in per.items():
            check(math.isfinite(r["alpha"]) and r["alpha"] > 0,
                  f"[fig6] {kind} on {m} SMs: alpha {r['alpha']}")
            check(r["overlap"] >= 0.9, f"[fig6] {kind} on {m} SMs: two lanes of one SM "
                  f"overlapped for {r['overlap']:.3f} of the shorter")
        print(f"[fig6] ({smi}) on {m} SMs: " + "; ".join(
            f"{kind} alpha {r['alpha']:.4f} (a lane {r['alone_us']:.2f} us alone, "
            f"{r['both_us']:.2f} us with two, overlap >= {r['overlap']:.3f}; makespan ratio "
            f"{r['makespan_alpha']:.4f})"
            for kind, r in per.items()))
    kinds = list(measured[n_sms])
    print(f"[fig6] ({smi}) Eq. 10 gain a type, measured on {n_sms} SMs / paper table: " + "; ".join(
        f"{kind} {rows[f'fig14_measured_gain_used_{kind}']:.4f} / "
        f"{rows[f'fig14_gain_used_{kind}']:.4f}" for kind in kinds)
        + f"; Eq. 9 on the five-task set {rows['fig14_measured_gain_total_5tasks']:.4f} / "
        f"{rows['fig14_gain_total_5tasks']:.4f}; per-type gains "
        f"{rows['fig14_measured_gain_min']:.4f}..{rows['fig14_measured_gain_max']:.4f} / "
        f"{rows['fig14_gain_min']:.4f}..{rows['fig14_gain_max']:.4f}")
    seconds = time.perf_counter() - t0
    print(f"[fig6] ({smi}) {len(rows)} rows in {seconds:.1f} s")
    return {"rows": rows, "measured": {str(m): v for m, v in measured.items()},
            "seconds": seconds}


def phase_analysis(n_sms: int, smi: str) -> dict:
    """Algorithm 2 (``grid_search_frontier``, tightened, ``max_nodes``
    ANALYSIS_NODES) over the card's SMs on Table-1 task sets, once with the
    numpy engine on the host and once with the torch engine on the card.
    Both searches make the same calls in the same order, so every fixed
    point the torch engine answers is held to the numpy engine's answer to
    the same call (ANALYSIS_TOL; inf where it is inf), and the decisions,
    allocations and candidates tried must be identical.  Fails if the
    torch engine ran no fixed point on the card."""
    import numpy as np
    from repro_torch.core import GeneratorConfig, generate_taskset
    from repro_torch.core.rta_batch import _engine, grid_search_frontier

    engines = {"numpy": _engine("numpy"), "torch": _engine("torch")}
    check(engines["torch"].device.type == "cuda", "[analysis] the torch engine is not on the card")
    answers = {name: [] for name in engines}

    def recording(name):
        real = engines[name].fixed_point_batch

        def fixed_point_batch(*args, **kw):
            out = real(*args, **kw)
            answers[name].append(np.array(out))
            return out
        return fixed_point_batch

    before = dict(engines["torch"].fixed_points)
    seconds, tried, sets = {"numpy": 0.0, "torch": 0.0}, {"numpy": 0, "torch": 0}, []
    with contextlib.ExitStack() as stack:
        for name, engine in engines.items():
            stack.enter_context(mock.patch.object(engine, "fixed_point_batch", recording(name)))
        for util, seed in ANALYSIS_SETS:
            ts = generate_taskset(np.random.default_rng(seed), util, GeneratorConfig(
                n_tasks=ANALYSIS_TASKS, n_subtasks=ANALYSIS_SUBTASKS))
            res, took = {}, {}
            for name in engines:
                for v in answers.values():
                    v.clear()
                t0 = time.perf_counter()
                res[name] = grid_search_frontier(ts, n_sms, tightened=True,
                                                 max_nodes=ANALYSIS_NODES, backend=name)
                took[name] = time.perf_counter() - t0
                seconds[name] += took[name]
                tried[name] += res[name].candidates_tried
                if name == "numpy":
                    want = list(answers["numpy"])
            a, b = res["numpy"], res["torch"]
            what = f"[analysis] utilisation {util}, seed {seed}"
            check((a.schedulable, a.alloc, a.candidates_tried)
                  == (b.schedulable, b.alloc, b.candidates_tried),
                  f"{what}: numpy {a.schedulable} {a.alloc} after {a.candidates_tried} "
                  f"candidates, torch {b.schedulable} {b.alloc} after {b.candidates_tried}")
            got = answers["torch"]
            check(len(got) == len(want), f"{what}: {len(want)} fixed-point calls on numpy, "
                  f"{len(got)} on torch")
            err, n_fp = 0.0, 0
            for x, y in zip(want, got):
                check(x.shape == y.shape and np.array_equal(np.isinf(x), np.isinf(y)),
                      f"{what}: a fixed point is inf on one engine only")
                fin = np.isfinite(x)
                n_fp += x.size
                if fin.any():
                    err = max(err, float(np.max(np.abs(x[fin] - y[fin]))))
            if a.schedulable:
                err = max(err, max(abs(x - y) for x, y in zip(a.analysis.responses,
                                                               b.analysis.responses)))
            check(err <= ANALYSIS_TOL, f"{what}: R^ differs by {err:.3g} > {ANALYSIS_TOL:g}")
            sets.append({"util": util, "seed": seed, "schedulable": a.schedulable,
                         "alloc": a.alloc, "candidates_tried": a.candidates_tried,
                         "fixed_points": n_fp, "calls": len(want), "max_abs_err": err,
                         "seconds": took})
            print(f"[analysis] N={ANALYSIS_TASKS} M={ANALYSIS_SUBTASKS} utilisation {util} seed "
                  f"{seed} on {n_sms} SMs: schedulable {a.schedulable} {a.alloc or ''} after "
                  f"{a.candidates_tried} candidates (both engines); {len(want)} batched calls, "
                  f"{n_fp} fixed points, largest R^ difference {err:.3g}; numpy "
                  f"{took['numpy']:.3f} s, torch {took['torch']:.3f} s")
    ran = {k: engines["torch"].fixed_points[k] - before[k] for k in before}
    check(ran["device"] > 0, "[analysis] the torch engine ran no fixed point on the card")
    rate = {k: tried[k] / seconds[k] for k in engines}
    print(f"[analysis] {smi}: {len(ANALYSIS_SETS)} task sets, {tried['numpy']} candidates: "
          f"numpy (host) {seconds['numpy']:.3f} s, {rate['numpy']:.0f} candidates/s; torch "
          f"(card) {seconds['torch']:.3f} s, {rate['torch']:.0f} candidates/s; the torch "
          f"engine ran {ran['device']} fixed points on the card and handed {ran['numpy']} "
          f"to numpy")
    return {"sets": sets, "seconds": seconds, "candidates": tried, "candidates_per_s": rate,
            "torch_fixed_points": ran}


def check_matmul(m, k, n, dtype, gen, band_counts) -> float:
    """The kernel against matmul_ref: every work unit computed once, on an
    SM of its band, at each band count and on the card's last third of SMs
    (a range that starts past SM 0, as a second admitted service's does);
    bit-identical outputs across band counts and ranges and between traced
    and untraced launches, and for the wgmma variant from operands at a
    misaligned base (copied, same variant)."""
    import torch
    from repro_torch.kernels.persistent_matmul import (
        kernel_name, persistent_matmul, persistent_matmul_traced, sm_ids, tile_grid)
    from repro_torch.kernels.ref import matmul_ref

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dtype)
    want = matmul_ref(x, w)
    ids = sm_ids(x.device)
    last_third = (len(ids) // 3, len(ids) - len(ids) // 3)
    ranges = [(n_bands, 0) for n_bands in band_counts] + [last_third]
    outs = []
    for n_bands, first in ranges:
        got, trace = persistent_matmul_traced(x, w, n_bands, first)
        torch.cuda.synchronize()
        g = tile_grid(m, k, n, dtype, n_bands)
        hits = trace.tile_hits.cpu()
        check(trace.tiles_done == g.units == hits.numel() and bool((hits == 1).all()),
              f"matmul {m}x{k}x{n} n_bands={n_bands}: {trace.tiles_done} of {g.units} "
              f"units done, hits {hits.min().item()}..{hits.max().item()}")
        owner = torch.tensor([trace.allowed_sms[u // (2 * g.per_lane)] for u in range(g.units)],
                             dtype=torch.int32)
        check(trace.allowed_sms == ids[first:first + n_bands]
              and torch.equal(trace.tile_sm.cpu(), owner),
              f"matmul {m}x{k}x{n} SMs {first}+{n_bands}: a unit ran off its band's SM")
        outs.append(got)
    for (n_bands, first), o in zip(ranges[1:], outs[1:]):
        check(torch.equal(o, outs[0]),
              f"matmul {m}x{k}x{n} {dtype}: SMs {first}+{n_bands} differ from "
              f"n_bands={band_counts[0]}")
    check(torch.equal(persistent_matmul(x, w), outs[0]), "untraced launch differs")
    if kernel_name(m, k, n, dtype) == "pinned_wgmma_kernel":
        xs, ws = (torch.empty(t.numel() + 1, dtype=dtype, device="cuda")[1:].view(t.shape)
                  for t in (x, w))
        xs.copy_(x)
        ws.copy_(w)
        check(torch.equal(persistent_matmul(xs, ws), outs[0]),
              f"matmul {m}x{k}x{n}: misaligned operands give another result")
    err = (outs[0].float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok = err <= MATMUL_F32_TOL * max(1.0, want.abs().max().item())
    else:
        ok = torch.allclose(outs[0].float(), want.float(), rtol=MATMUL_BF16_TOL,
                            atol=MATMUL_BF16_TOL)
    check(ok, f"matmul {m}x{k}x{n} {dtype}: max abs err {err}")
    return err


def split(m, k, n, dtype) -> bool:
    """Whether the plan splits K for this shape (shape alone, any n_bands)."""
    from repro_torch.kernels.persistent_matmul import tile_grid

    return tile_grid(m, k, n, dtype, 1).n_slices > 1


# Ragged cases: K not a multiple of the slice, N narrow (16, 33) and not a
# multiple of 8 (130), or past one decode unit and not a multiple of it
# (600); every variant, element loads and bulk copies.
RAGGED_MATMUL = [(m, k, n) for m in (3, 4, 100, 512) for k in (200, 1000)
                 for n in (16, 33, 130)] + [(m, 200, n) for m in (3, 16, 100) for n in (130, 136)] \
    + [(m, 1000, 600) for m in (3, 4)]  # a decode unit cut short at N
# Ragged shapes of the wgmma variant (bf16, M > 16, K and N multiples of 8):
# M, N and K off the 128 x 128 x 64 tile, one tile and a partial box, split
# and unsplit.
RAGGED_WGMMA = [(100, 200, 136), (1000, 1000, 1032), (17, 64, 8), (300, 4104, 264),
                (130, 1000, 200), (1024, 1000, 3000)]


def flash_inputs(b, s, h, hkv, hd, dtype, gen):
    """q [B, S, H, hd] and k, v [B, S, Hkv, hd], as the model lays them out."""
    import torch

    return (torch.randn(b, s, n, hd, generator=gen, device="cuda").to(dtype)
            for n in (h, hkv, hkv))


def expand_heads(t, h):
    """[B, S, Hkv, hd] -> [B * H, S, hd]: KV heads repeated to the query
    heads, heads flattened into the batch (the [BH, S, hd] entry's input)."""
    b, s, n, hd = t.shape
    return t.repeat_interleave(h // n, dim=2).transpose(1, 2).reshape(b * h, s, hd).contiguous()


def check_flash(b, s, h, hkv, hd, dtype, window, gen, old_entry=False) -> float:
    """The model's route, ops.mha_flash on the card (one launch of
    flash_attention_gqa on the tensors as they are), against mha_flash_ref;
    with old_entry, also the [BH, S, hd] entry on the expanded tensors:
    bit-identical to it, and against flash_attention_ref."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref, mha_flash_ref

    q, k, v = flash_inputs(b, s, h, hkv, hd, dtype, gen)
    scale = hd ** -0.5
    before = flash_attention.launches
    got = ops.mha_flash(q, k, v, scale=scale, window=window)
    check(flash_attention.launches == before + 1,
          f"ops.mha_flash launched {flash_attention.launches - before} kernels, not one")
    want = mha_flash_ref(q, k, v, scale=scale, window=window)
    torch.cuda.synchronize()
    case = f"flash b={b} s={s} h={h}/{hkv} hd={hd} {dtype} window={window}"
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = (got.float() - want.float()).abs().max().item()
    check(got.shape == (b, s, h * hd) and bool(torch.isfinite(got).all()) and
          torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"{case}: max abs err {err}")
    if old_entry:
        qf, kf, vf = (expand_heads(t, h) for t in (q, k, v))
        old = flash_attention(qf, kf, vf, scale=scale, window=window)
        check(torch.equal(old, got.view(b, s, h, hd).transpose(1, 2).reshape(b * h, s, hd)),
              f"{case}: the [BH, S, hd] entry differs from the [B, S, H, hd] entry")
        ref = flash_attention_ref(qf, kf, vf, scale=scale, window=window)
        check(torch.allclose(old.float(), ref.float(), rtol=tol, atol=tol),
              f"{case}: the [BH, S, hd] entry against flash_attention_ref: max abs err "
              f"{(old.float() - ref.float()).abs().max().item()}")
    return err


def scan_inputs(b, s, d, n, c_dtype, gen):
    """abar in (0.5, 1) (the model's exp(dt * A) < 1), bx of the scale the
    model gives, c in c_dtype."""
    import torch

    abar = torch.rand(b, s, d, n, generator=gen, device="cuda") * 0.5 + 0.5
    bx = torch.randn(b, s, d, n, generator=gen, device="cuda") * 0.1
    c = torch.randn(b, s, n, generator=gen, device="cuda").to(c_dtype)
    return abar, bx, c


def check_scan(b, s, d, n, c_dtype, h0_kind, gen) -> float:
    """selective_scan against selective_scan_ref: y and the final state."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan

    abar, bx, c = scan_inputs(b, s, d, n, c_dtype, gen)
    h0 = {"none": None, "zero": torch.zeros(b, d, n, device="cuda"),
          "random": torch.randn(b, d, n, generator=gen, device="cuda")}[h0_kind]
    got = selective_scan(abar, bx, c, h0)
    want = selective_scan_ref(abar, bx, c, h0)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("y", "h_out"), got, want):
        e = (g - w).abs().max().item()
        check(bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=SCAN_TOL, atol=SCAN_TOL),
              f"selective_scan {(b, s, d, n)} c {c_dtype} h0 {h0_kind}: {name} max abs err {e}")
        err = max(err, e)
    return err


def matmul_rows(cfg, calls: dict, gen) -> list[dict]:
    """Device time of each (M, K, N, dtype) the path launches, beside the
    plain version, torch.matmul and the bound."""
    import torch
    from repro_torch.kernels.persistent_matmul import kernel_name, persistent_matmul
    from repro_torch.kernels.ref import matmul_ref

    rows = []
    for (m, k, n, dt_name), n_calls in sorted(calls.items()):
        dt = getattr(torch, dt_name)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        n_w = max(2, int(120e6 // (k * n * x.element_size())) + 1)
        ws = [(torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
              for _ in range(n_w)]
        args = [(x, w) for w in ws]
        iters = max(20, n_w)  # one graph walks the whole ring
        eb = x.element_size()
        rows.append({
            "m": m, "k": k, "n": n, "dtype": dt_name, "calls": n_calls,
            "kernel": kernel_name(m, k, n, dt),
            "ms": time_ms(cycling(persistent_matmul, args), iters),
            "eager_ms": eager_ms(cycling(persistent_matmul, args)),
            "plain_ms": time_ms(cycling(matmul_ref, args), iters),
            "library_ms": time_ms(cycling(torch.matmul, args), iters),
            **bound((m * k + k * n + m * n) * eb, 2.0 * m * n * k, f32=dt == torch.float32),
        })
        rows[-1]["gb_s"] = (m * k + k * n + m * n) * eb / rows[-1]["ms"] / 1e6
        del ws, args

    def gb_s(r):  # achieved rate where the launch is bound by bytes (decode)
        return f", {r['gb_s']:.0f} GB/s" if r["m"] <= 4 else ""

    for r in rows:
        print(f"[kernels] {cfg.name} matmul M={r['m']} K={r['k']} N={r['n']} {r['dtype']} "
              f"x{r['calls']} on {r['kernel']}: {r['ms']:.4f} ms{gb_s(r)} (issued eagerly "
              f"{r['eager_ms']:.4f}; plain "
              f"{r['plain_ms']:.4f}, torch.matmul {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


def flash_row(cfg, calls: int, gen) -> dict:
    """ops.mha_flash as the main path calls it, on [B, S, H, hd] q and [B,
    S, Hkv, hd] k/v, beside mha_flash_ref, SDPA on [B, H, S, hd] views of the
    same tensors (a yardstick the port never calls), the bound, and the
    [BH, S, hd] entry on expanded inputs (ms_expanded, the kernel alone)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, kernel_name
    from repro_torch.kernels.ref import mha_flash_ref

    dt, hd, h, hkv = getattr(torch, cfg.dtype), cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = flash_inputs(BATCH, PROMPT, h, hkv, hd, dt, gen)
    qf, kf, vf = (expand_heads(t, h) for t in (q, k, v))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scale = hd ** -0.5
    n_bytes = 2 * BATCH * PROMPT * (h + hkv) * hd * q.element_size()  # q, o; k, v
    row = {
        "b": BATCH, "s": PROMPT, "h": h, "hkv": hkv, "hd": hd, "calls": calls,
        "kernel": kernel_name(dt, hd),
        "ms": time_ms(lambda: ops.mha_flash(q, k, v, scale=scale)),
        "eager_ms": eager_ms(lambda: ops.mha_flash(q, k, v, scale=scale)),
        "ms_expanded": time_ms(lambda: flash_attention(qf, kf, vf, scale=scale)),
        "plain_ms": time_ms(lambda: mha_flash_ref(q, k, v, scale=scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True)),
        # causal work: query i attends i+1 keys, two products of hd each
        **bound(n_bytes, 4.0 * hd * BATCH * h * PROMPT * (PROMPT + 1) / 2),
    }
    print(f"[kernels] {cfg.name} flash B={BATCH} S={PROMPT} H={h}/{hkv} hd={hd} x{calls} on "
          f"{row['kernel']}: ops.mha_flash {row['ms']:.4f} ms, {row['ms'] / row['library_ms']:.2f}"
          f"x sdpa (issued eagerly {row['eager_ms']:.4f}; [BH, S, hd] entry on expanded inputs "
          f"{row['ms_expanded']:.4f}; plain {row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f} by {row['bound_by']})")
    return row


def scan_rows(cfg, calls: int, gen) -> list[dict]:
    """The prefill chunk's scan with and without h0 (the first chunk starts
    from zero), each taking half of the path's launches."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan

    chunk, _ = scan_chunks()
    b, d, n = BATCH, cfg.d_inner, cfg.mamba_d_state
    abar, bx, c = scan_inputs(b, chunk, d, n, getattr(torch, cfg.dtype), gen)
    rows = []
    for h0 in (None, torch.randn(b, d, n, generator=gen, device="cuda")):
        n_bytes = (2 * abar.numel() + b * chunk * d) * 4 + c.numel() * c.element_size() \
            + b * d * n * 4 * (1 if h0 is None else 2)
        row = {
            "b": b, "s": chunk, "d": d, "n": n, "h0": h0 is not None, "calls": calls // 2,
            "ms": time_ms(lambda: selective_scan(abar, bx, c, h0)),
            "eager_ms": eager_ms(lambda: selective_scan(abar, bx, c, h0)),
            "plain_ms": time_ms(lambda: selective_scan_ref(abar, bx, c, h0), iters=5, reps=2),
            "library_ms": None,  # no single PyTorch call computes the scan
            # per state and step: one FMA for h, a multiply-add for y
            **bound(n_bytes, 4.0 * abar.numel(), f32=True),
        }
        row["gb_s"] = n_bytes / row["ms"] / 1e6
        rows.append(row)
        print(f"[kernels] {cfg.name} selective_scan B={b} S={chunk} D={d} N={n} "
              f"h0={row['h0']} x{row['calls']}: {row['ms']:.4f} ms, {row['gb_s']:.0f} GB/s "
              f"(issued eagerly {row['eager_ms']:.4f}; plain {row['plain_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f} by {row['bound_by']})")
    return rows


def phase_kernels_qwen(cfg, n_sms) -> dict:
    import torch
    from repro_torch.kernels.persistent_matmul import kernel_name

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, cfg.dtype)
    calls = matmul_calls(cfg)

    # correctness
    mm_err = {}
    for m, k, n, _ in calls:
        for dtype in (torch.bfloat16, torch.float32):
            mm_err[(m, k, n, str(dtype))] = check_matmul(m, k, n, dtype, gen, (1, 8, n_sms))
    ragged = [(m, k, n, dtype) for m, k, n in RAGGED_MATMUL
              for dtype in (torch.float32, torch.bfloat16)]
    for m, k, n, dtype in ragged:
        check_matmul(m, k, n, dtype, gen, (1, 8, n_sms))
    for m, k, n in RAGGED_WGMMA:
        check(kernel_name(m, k, n, torch.bfloat16) == "pinned_wgmma_kernel",
              f"{m}x{k}x{n} is not a wgmma shape")
        check_matmul(m, k, n, torch.bfloat16, gen, (1, 8, n_sms))
    ragged += RAGGED_WGMMA
    print(f"[kernels] persistent_matmul: {len(mm_err) + len(ragged)} shapes x 3 band counts ok; "
          f"max abs err bf16 {max(v for key, v in mm_err.items() if 'bfloat16' in key[3]):.3g}, "
          f"f32 {max(v for key, v in mm_err.items() if 'float32' in key[3]):.3g}")
    hd = cfg.head_dim
    fl_err = check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, dt, None, gen,
                         old_entry=True)
    fl_extra = {
        "window64_bf16": check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, dt, 64, gen),
        "group1": check_flash(2, PROMPT, 4, 4, hd, dt, None, gen, old_entry=True),
        "group2_window64": check_flash(2, PROMPT, 4, 2, hd, dt, 64, gen, old_entry=True),
        "group4": check_flash(2, PROMPT, 8, 2, hd, dt, None, gen),
        "group4_ragged77": check_flash(2, 77, 8, 2, hd, dt, None, gen),
        "group3_ragged200_window64": check_flash(1, 200, 3, 1, hd, dt, 64, gen),
        "f32": check_flash(2, PROMPT, 4, 2, hd, torch.float32, None, gen),
        "f32_window64_ragged_hd64": check_flash(2, 200, 4, 2, 64, torch.float32, 64, gen),
        "f32_hd32_ragged": check_flash(1, 77, 2, 1, 32, torch.float32, None, gen),
        "bf16_window64_ragged_hd64": check_flash(2, 200, 4, 2, 64, torch.bfloat16, 64, gen),
        "bf16_hd32_ragged": check_flash(1, 77, 2, 1, 32, torch.bfloat16, None, gen,
                                        old_entry=True),
    }
    print(f"[kernels] flash_attention ok: max abs err {fl_err:.3g} (path), {fl_extra}")

    # timing at the path's shapes, in the path's dtype, on all SMs
    expected = expected_launches(cfg)
    bf16_err = max(v for key, v in mm_err.items() if key[3] == str(dt))
    return {"matmul_rows": matmul_rows(cfg, calls, gen),
            "flash_rows": [flash_row(cfg, expected["flash_attention"], gen)],
            "scan_rows": [],
            "matmul_err": bf16_err, "flash_err": fl_err, "flash_extra_err": fl_extra}


def phase_kernels_jamba(cfg, n_sms) -> dict:
    import torch
    from repro_torch.kernels.persistent_matmul import kernel_name

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = getattr(torch, cfg.dtype)
    chunk, _ = scan_chunks()
    d, n = cfg.d_inner, cfg.mamba_d_state

    # selective_scan: the prefill chunk's shape, then ragged S, D and every N
    scan_err = {}
    for c_dtype in (torch.float32, torch.bfloat16):
        for h0 in ("none", "zero", "random"):
            scan_err[(chunk, d, n, str(c_dtype), h0)] = check_scan(
                BATCH, chunk, d, n, c_dtype, h0, gen)
    ragged = [(s, dd, nn, c_dtype, h0) for s in (1, 77, 200) for dd, nn in
              ((100, 16), (300, 8), (70, 4), (257, 16)) for c_dtype, h0 in
              ((torch.float32, "random"), (torch.bfloat16, "none"))]
    for s, dd, nn, c_dtype, h0 in ragged:
        check_scan(2, s, dd, nn, c_dtype, h0, gen)
    path_err = max(v for key, v in scan_err.items() if key[3] == str(dt))
    print(f"[kernels] selective_scan: {len(scan_err)} path cases and {len(ragged)} ragged "
          f"cases ok; max abs err {max(scan_err.values()):.3g} (path, c {cfg.dtype} "
          f"{path_err:.3g})")

    # persistent_matmul at jamba's projection shapes, all SMs; flash at its head shape
    calls = matmul_calls(cfg)
    mm_err = {}
    for m, k, n, dt_name in calls:  # all band counts where K is split or wgmma runs
        dtype = getattr(torch, dt_name)
        every = split(m, k, n, dtype) or kernel_name(m, k, n, dtype) == "pinned_wgmma_kernel"
        mm_err[(m, k, n, dt_name)] = check_matmul(
            m, k, n, dtype, gen, (1, 8, n_sms) if every else (n_sms,))
    print(f"[kernels] persistent_matmul at {len(mm_err)} jamba shapes ok; max abs err "
          f"{max(mm_err.values()):.3g}")
    fl_err = check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt, None, gen,
                         old_entry=True)
    fl_win = check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt, 64, gen)
    print(f"[kernels] flash_attention at jamba's shape ok: max abs err {fl_err:.3g} "
          f"(window 64: {fl_win:.3g})")

    expected = expected_launches(cfg)
    return {"matmul_rows": matmul_rows(cfg, calls, gen),
            "flash_rows": [flash_row(cfg, expected["flash_attention"], gen)],
            "scan_rows": scan_rows(cfg, expected["selective_scan"], gen),
            "matmul_err": max(v for key, v in mm_err.items() if key[3] == cfg.dtype),
            "flash_err": fl_err, "scan_err": path_err}


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def prefill_f32(model, tokens):
    """Prefill logits of a float32 copy of the model on the plain versions,
    one block at a time (a float32 copy of a whole large model need not
    fit beside the bf16 one): cast a block, run it, free it.

    Also returns, per block, the relative L2 error of the block's update
    (output minus input) in the model's dtype, on the kernels and on the
    plain versions, against the float32 block's, each fed the float32
    run's input to that block: one block's error, without what the blocks
    before it passed on."""
    import torch
    from repro_torch.models.blocks import block_prefill, init_block_cache
    from repro_torch.models.layers import apply_norm

    cfg, f32 = model.cfg, torch.float32
    x = model._embed(tokens).float()
    block_errs = []
    for i, block in enumerate(model.layers):
        spec = model._spec(i)

        def update(blk, dtype):
            cache = init_block_cache(cfg, spec, tokens.shape[0], MAX_CONTEXT, dtype,
                                     model.device)
            x_in = x.to(dtype)
            out, _ = block_prefill(blk, cfg, spec, x_in, cache, cfg.sliding_window)
            return out.float() - x_in.float(), out

        kernels, _ = update(block, model.dtype)
        with plain_kernels():
            plain, _ = update(block, model.dtype)
            block32 = copy.deepcopy(block).float()
            want, x = update(block32, f32)
        block_errs.append({"layer": i, "mixer": spec.mixer, "ffn": spec.ffn,
                           "kernels": rel_l2(kernels, want), "plain": rel_l2(plain, want)})
        del block32, kernels, plain, want
    x = apply_norm(copy.deepcopy(model.final_norm).float(), x, cfg.norm)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    return x[:, -1:] @ head["w"].float().T, block_errs


def graphs_match_eager(engine, prompts, held, replayed) -> dict:
    """The prompts' jobs on SMs ``held`` issued op by op (the engine's eager
    steps), each against the tokens the graph replays gave (``replayed``):
    equal.  Returns the last eager job's prefill ms and decode ms/step
    (CUDA events)."""
    import numpy as np

    eager = [engine._generate(p, NEW_TOKENS, None, held, eager=True) for p in prompts]
    for i, ((out, _), want) in enumerate(zip(eager, replayed)):
        check(np.array_equal(out, want), f"{engine.cfg.name} on SMs {held}: job {i}'s tokens "
              f"from the graph replays differ from the eager path's")
    stats = {"prefill_ms": eager[-1][1]["prefill_s"] * 1e3,
             "decode_ms": eager[-1][1]["decode_s_per_tok"] * 1e3}
    print(f"[graphs] {engine.cfg.name} on SMs {held}: {len(prompts)} jobs as graph replays and "
          f"issued eagerly, identical tokens; eager prefill {stats['prefill_ms']:.3f} ms, decode "
          f"{stats['decode_ms']:.3f} ms/step (CUDA events)")
    return stats


def phase_main_path(cfg) -> dict:
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.graphs import WARMUP

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, ServeConfig(max_context=MAX_CONTEXT, batch=BATCH), seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    capture_s = engine.capture(PROMPT)
    prefill_graph, decode_graph = engine.steps(PROMPT).graphs
    print(f"[main] {cfg.name}: the prefill and decode steps captured as CUDA graphs on all SMs "
          f"in {capture_s:.2f} s ({WARMUP} eager runs each first); one replay holds "
          f"{prefill_graph.launches} and {decode_graph.launches} launches")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
               for _ in range(ROUNDS)]

    counters = zeroed_counters()
    rounds, outs = [], []
    for p in prompts:
        t1 = time.perf_counter()
        out, stats = engine.generate(p, max_new_tokens=NEW_TOKENS)
        stats["wall_s"] = time.perf_counter() - t1
        rounds.append(stats)
        outs.append(out)
        check(out.shape == (BATCH, NEW_TOKENS), f"tokens shape {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token outside the vocab")
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[main] {cfg.name}: launches on the main path: {launches}")
    expected = expected_launches(cfg)
    check(all(launches[k] > 0 for k, v in expected.items() if v),
          f"a kernel of the path was not launched on the main path: {launches}")
    check(launches == expected, f"launches {launches} != expected {expected}")
    check(prefill_graph.replays == decode_graph.replays // NEW_TOKENS == ROUNDS,
          f"{cfg.name}: {prefill_graph.replays} prefill and {decode_graph.replays} decode "
          f"replays, {ROUNDS} rounds run")
    peak_serve_gb = torch.cuda.max_memory_allocated() / 1e9
    eager = graphs_match_eager(engine, prompts, (None, 0), outs)

    model = engine.model
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts[0], device="cuda")
        got, _ = model.prefill(tokens, model.init_caches(BATCH, MAX_CONTEXT))
        before = {name: fn.launches for name, fn in counters.items()}
        with plain_kernels():
            want, _ = model.prefill(tokens, model.init_caches(BATCH, MAX_CONTEXT))
        moved = {name: fn.launches - before[name] for name, fn in counters.items()}
        check(not any(moved.values()), f"{cfg.name}: the plain path launched kernels: {moved}")
        truth, block_errs = prefill_f32(model, tokens)
    got, want = got.float(), want.float()
    check(got.shape == (BATCH, 1, cfg.vocab) and bool(torch.isfinite(got).all()),
          f"prefill logits {tuple(got.shape)} not finite or mis-shaped")

    rel, noise, rel_truth = rel_l2(got, want), rel_l2(want, truth), rel_l2(got, truth)
    argmax_agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    max_abs = (got - want).abs().max().item()
    check(rel <= LOGITS_NOISE_FACTOR * noise and rel_truth <= LOGITS_NOISE_FACTOR * noise,
          f"{cfg.name} prefill logits: kernels vs plain rel L2 {rel}, vs float32 {rel_truth}; "
          f"plain bf16 vs float32 {noise} (factor {LOGITS_NOISE_FACTOR})")

    steady = rounds[-1]
    tok_s = BATCH / steady["decode_s_per_tok"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] {cfg.name} bf16 batch {BATCH}: prefill {steady['prefill_s'] * 1e3:.3f} ms "
          f"({BATCH}x{PROMPT} tokens), decode {steady['decode_s_per_tok'] * 1e3:.3f} ms/step, "
          f"{tok_s:.1f} tokens/s (graph replays, CUDA events); round walls "
          f"{[round(r['wall_s'], 4) for r in rounds]} s; init {init_s:.1f} s")
    print(f"[main] {cfg.name} prefill logits rel L2: kernels vs plain {rel:.4g}, kernels vs "
          f"float32 {rel_truth:.4g}, plain bf16 vs float32 {noise:.4g}; max abs {max_abs:.3g}, "
          f"argmax agreement {argmax_agree:.3f}")
    worst = max(block_errs, key=lambda e: e["kernels"])
    per_block = " ".join("{kernels:.3g}/{plain:.3g}".format(**e) for e in block_errs)
    print(f"[main] {cfg.name} one block's update against float32, rel L2, kernels/plain: "
          f"{per_block}; worst layer {worst['layer']} ({worst['mixer']}+{worst['ffn']})")
    print(f"[main] {cfg.name} peak device memory: serving {peak_serve_gb:.2f} GB, with the "
          f"checks {peak_gb:.2f} GB")
    return {"engine": engine, "prompt": prompts[0],
            "launches": launches, "rounds": rounds, "init_s": init_s, "capture_s": capture_s,
            "eager": eager,
            "logits_rel_l2": rel, "logits_rel_l2_vs_f32": rel_truth,
            "plain_bf16_rel_l2_vs_f32": noise, "block_update_rel_l2": block_errs,
            "logits_max_abs": max_abs, "argmax_agree": argmax_agree,
            "peak_mem_gb": peak_gb, "peak_serving_mem_gb": peak_serve_gb}


def _profile(fn, steps: int) -> dict:
    """Device time by kernel over ``steps`` calls of fn under torch.profiler,
    and the device's busy share of the wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host ops: their device time is their kernels' time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count, "device_ms": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    pinned = collections.Counter()  # the pinned matmul's and flash's variants: launches, ms
    pinned_ms = collections.Counter()
    for r in rows:
        found = re.search(r"((pinned|flash)_[a-z0-9]+_kernel)", r["name"])
        if found:
            pinned[found.group(1)] += r["calls"]
            pinned_ms[found.group(1)] += r["device_ms"]
    return {"wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy,
            "idle_share": (1.0 - busy * steps / wall_ms) if rows else None,
            "device_ops_per_step": sum(r["calls"] for r in rows) / steps,
            "pinned_launches": dict(pinned), "pinned_ms": dict(pinned_ms), "top": rows[:12]}


def phase_profile(engine, prompt) -> dict:
    """One prefill and eight decode steps under the profiler, as graph
    replays and issued eagerly, on all SMs."""
    import torch

    model = engine.model
    steps = {"prefill": 1, "decode": 8}
    out = {}
    for way in ("graph", "eager"):
        step = engine.steps(PROMPT, eager=way == "eager")
        engine._static.prompts[PROMPT].copy_(torch.as_tensor(prompt))
        out[f"prefill_{way}"] = _profile(step.prefill, steps["prefill"])
        step.decode()
        out[f"decode_{way}"] = _profile(step.decode, steps["decode"])
    for phase, r in out.items():
        n = steps[phase.split("_")[0]]
        if r["idle_share"] is None:
            print(f"[profile] {model.cfg.name} {phase}: the profiler saw no device time "
                  f"(not measured)")
            continue
        print(f"[profile] {model.cfg.name} {phase}: wall {r['wall_ms_per_step']:.3f} ms/step "
              f"under the profiler, device busy {r['device_ms_per_step']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['device_ops_per_step']:.0f} device ops/step")
        for row in r["top"][:6]:
            print(f"[profile]   {row['device_ms']:.4f} ms  x{row['calls']}  {row['name'][:90]}")
        for name, calls in sorted(r["pinned_launches"].items()):
            kind = "pinned matmul" if name.startswith("pinned") else "flash attention"
            print(f"[profile]   {kind} {name}: x{calls // n}/step, "
                  f"{r['pinned_ms'][name]:.4f} ms/step")
    want = prefill_kernels(model.cfg)
    for way in ("graph", "eager"):
        r = out[f"prefill_{way}"]
        if r["idle_share"] is not None:
            check(r["pinned_launches"] == want,
                  f"{model.cfg.name} prefill ({way}): matmul and flash launches by kernel "
                  f"{r['pinned_launches']}, the shapes give {want}")
    return out


def print_calibration(name, meas: dict, sms, why: str = "") -> None:
    for m in sms:
        dev, jobs = meas[m]["device_ms"], meas[m]["job_ms"]
        print(f"[rt] {name}: decode step on {m} SMs{why}: device busy "
              f"{' '.join(f'{t:.4f}' for t in dev)} ms (largest {max(dev):.4f}); prefill "
              f"walls {' '.join(f'{t:.3f}' for t in meas[m]['prefill_ms'])} ms"
              + (f"; whole job walls {' '.join(f'{t:.1f}' for t in jobs)} ms (largest "
                 f"{max(jobs):.3f})" if jobs else ""))


def print_independence(name, cal, sms) -> dict:
    """The lag-1 autocorrelation and runs test of the calibration's job
    walls in timing order, pooled and per SM count: the pWCET's fit takes
    them as independent."""
    from repro_torch.runtime.task_spec import independence

    pooled = independence(cal.job_ms)
    per = {m: independence(cal.measured[m]["job_ms"]) for m in sms}
    print(f"[rt] {name}: independence of the {len(cal.job_ms)} calibration job walls in timing "
          f"order, which the pWCET assumes: lag-1 autocorrelation {pooled['lag1']:.4f}; runs "
          f"above/below the median {pooled['runs']} against {pooled['expected']:.1f} expected, "
          f"z {pooled['z']:.3f}, p {pooled['p']:.3g}; per SM count: " + "; ".join(
              f"{m}: lag-1 {r['lag1']:.3f}, runs {r['runs']} of {r['expected']:.1f}, "
              f"p {r['p']:.3g}" for m, r in per.items()))
    return {"pooled": pooled, "per_sm_count": per}


def pooled_task(spec, cal):
    """``spec``'s task under the pooled rule, for comparison: the pWCET of
    every count's job walls pooled in timing order, less the largest
    prefill wall, spread over the decode CPU segments, so the CPU segments
    carry device time the GPU segments bound again."""
    from repro_torch.runtime.task_spec import measured_task_to_rt, pwcet_ms

    host_step = max(pwcet_ms(cal.job_ms) - cal.prefill_ms(), 0.0) / NEW_TOKENS
    return measured_task_to_rt(spec, cal.fit(), host_step, cal.prefill_ms())


def print_host_parts(name, cal, sms) -> dict:
    """Each count's calibration jobs split on the job path: each job's
    device span (its prefill's and 16 decode steps' CUDA-event spans), its
    largest decode step, which t(m) must cover, and its rest (the wall less
    the spans: the host's part), the rests' independence in timing order,
    each count's pWCET of them and the largest, which the decode CPU
    segments carry; beside them the earlier rule's (the wall less the
    smallest prefill wall and 16 smallest profiled busy steps)."""
    from repro_torch.runtime.task_spec import independence

    pwcets, out = cal.host_pwcets_ms(), {}
    earlier = cal.host_pwcets_ms(cal.earlier_host_parts_ms)
    for m in sms:
        row, host = cal.measured[m], cal.host_parts_ms(m)
        spans = [p + sum(st) for p, st in zip(row["prefill_span_ms"], row["step_span_ms"])]
        steps = [max(st) for st in row["step_span_ms"]]
        check(cal.step_ms(m) >= max(steps), f"{name}: t({m}) {cal.step_ms(m):.4f} ms below a "
              f"job's decode step, {max(steps):.4f} ms")
        ind = independence(host)
        out[m] = {"rest_ms": host.tolist(), "device_span_ms": spans, "largest_step_ms": steps,
                  "pwcet_ms": pwcets[m], "independence": ind, "t_ms": cal.step_ms(m),
                  "earlier_host_ms": cal.earlier_host_parts_ms(m).tolist(),
                  "earlier_pwcet_ms": earlier[m], "device_lower_ms": cal.device_lower_ms(m)}
        print(f"[rt] {name}: the {len(host)} jobs on {m} SMs: device spans (prefill and "
              f"{NEW_TOKENS} decode steps, CUDA events) {' '.join(f'{t:.2f}' for t in spans)} ms; "
              f"each job's largest decode step {' '.join(f'{t:.3f}' for t in steps)} ms, all <= "
              f"t({m}) {cal.step_ms(m):.4f} ms (largest profiled busy step "
              f"{max(row['device_ms']):.4f}); rests (wall less the spans) "
              f"{' '.join(f'{h:.2f}' for h in host)} ms; lag-1 {ind['lag1']:.3f}, runs "
              f"{ind['runs']} of {ind['expected']:.1f}, p {ind['p']:.3g}; pWCET {pwcets[m]:.3f} "
              f"ms (the earlier rule's, the wall less {cal.device_lower_ms(m):.3f} ms: "
              f"{earlier[m]:.3f} ms)")
    worst = max(pwcets, key=pwcets.get)
    print(f"[rt] {name}: host bound, the largest count's pWCET of the rests: "
          f"{cal.host_bound_ms():.3f} ms (on {worst} SMs; per count " + ", ".join(
              f"{m}: {v:.3f}" for m, v in pwcets.items())
          + f"), {cal.host_step_ms():.4f} ms on each decode CPU segment; the earlier rule's "
          f"{cal.earlier_host_bound_ms():.3f} ms")
    return {"per_sm_count": out, "host_bound_ms": cal.host_bound_ms(), "largest_at": worst,
            "earlier_host_bound_ms": cal.earlier_host_bound_ms()}


class GraphTrace:
    """Traced pinned matmuls of the steps' graphs on GN SMs from SM 0.

    Inside :func:`traced_graphs` the engine's prefill and decode steps are
    captured with every pinned matmul traced into ``pool``, a
    ``TracePool`` of one prefill's and one decode step's work units, and
    each launch followed, in the graph, by a check of its units: ``seen``
    gains one for each unit whose SM (``TileTrace.tile_sm``, which the
    kernel writes at every replay) is the SM ``tile_of``'s map gives it on
    the GN allocated SMs.  ``tile_hits`` counts the unit's computations
    over every replay.  So after R replays of a graph, each of its units
    was computed R times and on its own SM at each replay iff hits ==
    seen == R.  ``launches`` lists ((M, K), N, dtype, (n_bands, first SM),
    TileTrace, seen) per captured launch."""

    def __init__(self, cfg, gn: int):
        import torch
        from repro_torch.kernels.persistent_matmul import TracePool, sm_ids, tile_grid

        self.gn = gn
        allowed = sm_ids(torch.device("cuda"))[:gn]
        self.owners = {}
        units = 0
        for (m, k, n, dt), calls in matmul_calls(cfg).items():
            dtype = getattr(torch, dt)
            g = tile_grid(m, k, n, dtype, gn)
            self.owners[(m, k, n, dtype)] = torch.tensor(
                [allowed[u // (2 * g.per_lane)] for u in range(g.units)], dtype=torch.int32,
                device="cuda")
            units += g.units * replays_per_capture(calls, m)
        self.pool = TracePool(units, "cuda")
        self.seen = torch.zeros(units, dtype=torch.int32, device="cuda")
        self.launches = []


def replays_per_capture(calls_on_path: int, m: int) -> int:
    """Launches of one (M, K, N) shape in one capture of the prefill and
    decode steps, from its launches on the main path."""
    return calls_on_path // (ROUNDS * (NEW_TOKENS if m == BATCH else 1))


@contextlib.contextmanager
def traced_graphs(engine, trace: GraphTrace):
    """Inside, the engine's steps of PROMPT-token prompts on (GN, 0) replay
    graphs captured with every pinned matmul traced (:class:`GraphTrace`);
    the warm-up before each capture runs untraced.  The engine's graphs are
    dropped on entry and on exit, so untraced steps are captured again."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.persistent_matmul import persistent_matmul, persistent_matmul_traced

    def traced(x, w, n_bands=None, first_sm=0):
        if not torch.cuda.is_current_stream_capturing():
            return persistent_matmul(x, w, n_bands, first_sm)
        a = trace.pool.used
        got, tile = persistent_matmul_traced(x, w, n_bands, first_sm, trace.pool)
        seen = trace.seen[a:trace.pool.used]
        owner = trace.owners.get((*x.shape, w.shape[1], x.dtype))
        if owner is not None:
            seen.add_(tile.tile_sm == owner)
        trace.launches.append((tuple(x.shape), w.shape[1], x.dtype, (n_bands, first_sm), tile,
                               seen))
        return got

    engine.release_graphs()
    with mock.patch.object(ops, "persistent_matmul", traced):
        engine.capture(PROMPT, (trace.gn, 0))
    try:
        yield trace
    finally:
        engine.release_graphs()


def check_on_gn(trace: GraphTrace, replays: dict, what: str) -> None:
    """Each traced launch carried n_bands = GN from SM 0 (the one service of
    its front door) and, over the R replays of its graph (``replays``:
    {"prefill": R, "decode": R}), ran every work unit R times, each time on
    its own one of the GN allocated SMs (:class:`GraphTrace`)."""
    from repro_torch.kernels.persistent_matmul import tile_grid

    gn = trace.gn
    for (m, k), n, dtype, held, tile, seen in trace.launches:
        r = replays["decode" if m == BATCH else "prefill"]
        check(held == (gn, 0), f"{what}: a matmul {m}x{k}x{n} ran on SMs {held}, not the "
              f"GN={gn} from SM 0 the service holds")
        check((m, k, n, dtype) in trace.owners, f"{what}: a matmul {m}x{k}x{n} {dtype} "
              f"off the path's shapes")
        g = tile_grid(m, k, n, dtype, gn)
        hits, seen = tile.tile_hits.cpu(), seen.cpu()
        check(tile.tiles_done == g.units == hits.numel() and bool((hits == r).all()),
              f"{what}: matmul {m}x{k}x{n}: {tile.tiles_done} of {g.units} units done at the "
              f"last replay, hits {hits.min().item()}..{hits.max().item()} over {r} replays")
        check(len(tile.allowed_sms) == gn and bool((seen == r).all()),
              f"{what}: matmul {m}x{k}x{n}: units on their own of the {gn} allocated SMs "
              f"{seen.min().item()}..{seen.max().item()} times in {r} replays")


def zeroed_counters() -> dict:
    """The kernels' launch counters, each set to 0."""
    from repro_torch.serving.graphs import kernel_counters

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def served_round(engine, prompt, gn: int, per_round: dict) -> dict:
    """One round through ``generate`` with the engine registered, as graphs
    captured with every pinned matmul traced and held to the GN SMs
    (:func:`check_on_gn`).  The kernels' counts are set to 0 just before
    and read just after."""
    import torch

    with traced_graphs(engine, GraphTrace(engine.cfg, gn)) as trace:
        counters = zeroed_counters()
        out, _ = engine.generate(prompt, max_new_tokens=NEW_TOKENS)
        counts = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
    check(out.shape == (BATCH, NEW_TOKENS), f"tokens shape {out.shape}")
    check(counts == per_round, f"registered round: launches {counts} != {per_round}")
    replays = {"prefill": 1, "decode": NEW_TOKENS}
    traced = sum(replays["decode" if s[0] == BATCH else "prefill"]
                 for s, *_ in trace.launches)
    check(traced == per_round["persistent_matmul"],
          f"registered round: {traced} traced matmuls replayed, "
          f"{per_round['persistent_matmul']} launches")
    check_on_gn(trace, replays, "registered round")
    return {"launches": counts, "captured": len(trace.launches),
            "shapes": len({(s, n, d) for s, n, d, *_ in trace.launches})}


def profiled_round(engine, prompt, gn: int) -> list[float]:
    """One round through ``generate`` with each decode step's replay in a
    profiler window of its own (``profiled_ms``): each step's device-busy
    ms."""
    from repro_torch.serving.engine import profiled_ms

    decode = engine.steps(PROMPT, (gn, 0)).graphs[1]
    replay, steps = decode.replay, []

    def profiled():
        steps.append(profiled_ms(replay)[1])

    with mock.patch.object(decode, "replay", profiled):
        engine.generate(prompt, max_new_tokens=NEW_TOKENS)
    check(len(steps) == NEW_TOKENS and all(steps),
          f"profiled round: {len(steps)} decode steps with device time, {NEW_TOKENS} run")
    return steps


def phase_rt(cfg, engine, prompt, n_sms: int, decode_s: float) -> dict:
    """Admission on the card through the engine's front door.  The engine
    measures the decode step and whole jobs of the prompt's shape at
    several SM counts (``engine.calibrate``); the deadline is the job's R̂ on a third of the
    SMs from that calibration, so 1 < GN < all.  ``engine.rt_register``
    admits the measured task on a port AdmissionController over the card's
    SMs, measuring each granted GN that is not a measured count and asking
    again.  The fit's prediction is held out: t(GN) against GR̂(GN) from
    the fit without GN's points.  Then three rounds through ``generate``,
    registered, each a replay of the steps' graphs on GN: traced (captured
    again with every matmul traced on the GN SMs), plain (the step's time),
    profiled (each decode step's device-busy time, held to GR̂(GN))."""
    from repro_torch.runtime import AdmissionController, ServingTaskSpec
    from repro_torch.runtime.task_spec import job_response_ms, kernel_type
    from repro_torch.serving.engine import CALIBRATION_STEPS

    t_phase = time.perf_counter()
    name = f"chat-{cfg.name}"
    # the analysis stops at the deadline, so R^ is read under a deadline far past it
    spec = ServingTaskSpec(name=name, arch_id=cfg.name, period_ms=2e9, deadline_ms=1e9,
                           batch=BATCH, seq_len=PROMPT, new_tokens=NEW_TOKENS,
                           dominant="memory_s", vocab=cfg.vocab)
    cal = engine.calibrate(spec)
    calibrated = sorted(cal.measured)
    print(f"[rt] {name}: the steps' graphs on {len(calibrated)} SM counts captured in "
          f"{sum(cal.measured[m]['capture_s'] for m in calibrated):.2f} s, each just before its "
          f"count's measurements")
    print_calibration(name, cal.measured, calibrated)
    independence = print_independence(name, cal, calibrated)
    host_parts = print_host_parts(name, cal, calibrated)
    target = n_sms // 3
    r_hat_target = job_response_ms(cal.task(spec), target)
    pooled_target = job_response_ms(pooled_task(spec, cal), target)
    deadline = math.ceil(r_hat_target * 1e3) / 1e3
    far, spec = spec, dataclasses.replace(spec, deadline_ms=deadline, period_ms=2 * deadline)
    print(f"[rt] {name}: deadline {deadline:.3f} ms, the job's R^ on {target} of {n_sms} SMs "
          f"(calibration fit, host part per SM count), period {2 * deadline:.3f} ms; the pooled "
          f"rule's R^ there on the same calibration {pooled_target:.3f} ms")
    ac = AdmissionController(gn_total=n_sms)
    t0 = time.perf_counter()
    dec = engine.rt_register(ac, spec)
    register_s = time.perf_counter() - t0
    check(dec.admitted, f"{name}: not admitted ({dec.reason})")
    granted = sorted(set(cal.measured) - set(calibrated))
    if granted:
        print(f"[rt] {name}: the steps' graphs on {granted} SMs (granted) captured in "
              f"{sum(cal.measured[m]['capture_s'] for m in granted):.2f} s before their "
              f"measurement")
    print_calibration(name, cal.measured, granted, " (granted, then measured)")
    gn = dec.alloc[name]
    check(engine.sm_range == (gn, 0), f"{name}: holds SMs {engine.sm_range}, granted {gn}")
    check(1 < gn < n_sms, f"{name}: granted GN={gn}, not between 1 and {n_sms}")
    task, fit = engine.rt_task, cal.fit()
    check(task == cal.task(spec), f"{name}: the admitted task is not the calibration's")
    t0 = time.perf_counter()
    check(AdmissionController(gn_total=n_sms).admit(task).admitted, f"{name}: re-admission")
    admit_ms = (time.perf_counter() - t0) * 1e3
    seg = task.gpu[0]
    gr_hi = cal.gr_hi(spec, gn)
    t_gn = cal.step_ms(gn)
    held_out = cal.gr_hi(spec, gn, held_out=True)
    check(t_gn <= gr_hi, f"{name}: t({gn})={t_gn:.4f} ms > GR^ {gr_hi:.4f} ms")
    check(t_gn <= held_out, f"{name}: the fit without {gn} SMs' points predicts GR^ "
          f"{held_out:.4f} ms < the step measured there, {t_gn:.4f} ms")
    job = next(t for t in dec.result.analysis.tasks if t.name == name)
    r_hat_far = job_response_ms(cal.task(far), gn)
    pooled_gn = job_response_ms(pooled_task(far, cal), gn)
    check(r_hat_far < pooled_gn, f"{name}: the job's R^ on GN={gn} {r_hat_far:.3f} ms is not "
          f"below the pooled rule's {pooled_gn:.3f} ms")
    check(all(job_response_ms(cal.task(far), m) >= max(cal.measured[m]["job_ms"])
              for m in calibrated), f"{name}: the job's R^ on a calibrated count is below a "
          f"calibration wall there")
    check(cal.alpha is not None and cal.alpha >= 1.0 and seg.alpha == cal.alpha,
          f"{name}: the task's alpha {seg.alpha}, measured {cal.alpha}")
    table = dataclasses.replace(cal, alpha=None)
    r_hat_table = job_response_ms(table.task(far), gn)
    print(f"[rt] {name}: alpha of the step's kernel type ({kernel_type(spec)}) measured on the "
          f"card, the largest over {calibrated} SMs: {cal.alpha:.4f}; the job's R^ on GN={gn} "
          f"{r_hat_far:.3f} ms at it, {r_hat_table:.3f} ms at the paper table's "
          f"{table.task(far).gpu[0].alpha}")
    wall_gw = decode_s * 1e3 * 2.0 * n_sms
    print(f"[rt] {name}: fit of t(m), the largest of {CALIBRATION_STEPS} profiled device-busy "
          f"decode steps and of the calibration jobs' decode-step spans, t(m) <= A/m + L: "
          + ", ".join(f"t({m})={cal.step_ms(m):.4f}" for m in sorted(cal.measured))
          + f" ms; A={fit.a_ms:.4f} ms*SM, L={fit.l_ms:.4f} ms")
    print(f"[rt] {name}: GW={seg.work_hi:.4f} ms (2A + L), GL={seg.overhead_hi:.4f} ms, "
          f"alpha={seg.alpha}, from device time only (a wall-based GW, step "
          f"{decode_s * 1e3:.4f} ms x 2 x {n_sms} SMs, would be {wall_gw:.4f} ms); CPU segment "
          f"per decode token {task.cpu_hi[1]:.4f} ms: sampling plus {cal.host_step_ms():.4f} ms, "
          f"1/{NEW_TOKENS} of the host bound {cal.host_bound_ms():.3f} ms (the largest of "
          f"{len(cal.host_pwcets_ms())} counts' pWCETs of the rests of {len(cal.job_ms)} "
          f"calibration jobs; the earlier rule's {cal.earlier_host_bound_ms():.3f} ms)")
    print(f"[rt] {name}: admitted on GN={gn} of {n_sms} SMs (SMs 0..{gn - 1}); registration "
          f"with its measurements {register_s:.1f} s, the controller's admission "
          f"{admit_ms:.3f} ms; segment GR^ on {2 * gn} virtual SMs {gr_hi:.4f} ms; job R^ "
          f"{job.response:.4f} ms (deadline {deadline:.3f}; the pooled rule's R^ on GN "
          f"{pooled_gn:.4f} ms); prefill wall on GN "
          f"{max(cal.measured[gn]['prefill_ms']):.3f} ms (largest of "
          f"{len(cal.measured[gn]['prefill_ms'])}) beside CPU segment 0 {task.cpu_hi[0]:.4f} ms "
          f"(the largest prefill, wall or a job's span, of every measured count, "
          f"{cal.prefill_ms():.3f} ms, plus the tokenize estimate)")
    print(f"[rt] {name}: held out: t({gn})={t_gn:.4f} ms <= GR^({gn}) {held_out:.4f} ms from the "
          f"fit without {gn} SMs' points ({t_gn / held_out:.3f})")

    eager_gn = graphs_match_eager(engine, [prompt], (gn, 0),
                                  [engine.generate(prompt, max_new_tokens=NEW_TOKENS)[0]])
    per_round = {k: v // ROUNDS for k, v in expected_launches(cfg).items()}
    served = served_round(engine, prompt, gn, per_round)
    print(f"[rt] {name}: registered round: launches {served['launches']} (a prefill and "
          f"{NEW_TOKENS} decode replays of graphs holding {served['captured']} traced matmuls), "
          f"every pinned matmul with n_bands={gn} and its work units on the {gn} allocated SMs "
          f"at every replay ({served['shapes']} shapes)")
    recapture_s = engine.rt_regraph()
    _, plain = engine.generate(prompt, max_new_tokens=NEW_TOKENS)
    busy = profiled_round(engine, prompt, gn)
    worst = max(busy)
    check(worst <= gr_hi, f"{name}: a decode step on GN={gn} SMs kept the device busy "
          f"{worst:.4f} ms > GR^ {gr_hi:.4f} ms")
    print(f"[rt] {name}: later round on GN={gn} SMs (untraced graphs captured again by "
          f"rt_regraph in {recapture_s:.2f} s): device-busy decode step mean "
          f"{sum(busy) / len(busy):.4f}, largest {worst:.4f} ms <= "
          f"GR^ {gr_hi:.4f} ms ({worst / gr_hi:.3f}); a step's replay "
          f"{plain['decode_s_per_tok'] * 1e3:.4f} ms (CUDA events) beside the CPU segment's "
          f"bound {task.cpu_hi[1]:.4f} ms")
    executed = phase_engine(engine, ac, spec, prompt, gn, per_round)
    check(engine.rt_deregister() and engine.sm_range is None, f"{name}: deregister failed")
    seconds = time.perf_counter() - t_phase
    print(f"[rt] {name}: phase {seconds:.1f} s")
    return {"fit": dataclasses.asdict(fit),
            "measured": {str(m): v for m, v in cal.measured.items()},
            "host_step_ms": cal.host_step_ms(), "calibration_job_ms": list(cal.job_ms),
            "host_parts": host_parts, "r_hat_target_ms": r_hat_target,
            "pooled_r_hat_target_ms": pooled_target, "pooled_r_hat_gn_ms": pooled_gn,
            "gpu_segment": dataclasses.asdict(seg),
            "wall_based_gw_ms": wall_gw, "deadline_ms": deadline, "period_ms": 2 * deadline,
            "gn": gn, "register_s": register_s, "admit_ms": admit_ms, "gr_hi_ms": gr_hi,
            "held_out_gr_hi_ms": held_out, "job_r_hat_ms": float(job.response),
            "independence": independence, "eager_on_gn": eager_gn,
            "served": served, "plain_decode_ms": plain["decode_s_per_tok"] * 1e3,
            "later_device_ms": busy, "worst_over_gr_hi": worst / gr_hi,
            "prefill_ms": cal.prefill_ms(), "cpu_segment0_ms": task.cpu_hi[0],
            "alpha": cal.alpha, "r_hat_gn_at_table_alpha_ms": r_hat_table,
            "engine": executed, "seconds": seconds}


def run_jobs(engine, spec, prompt, gn: int) -> dict:
    """The registered service alone under the port's ``WallClockExecutor``
    for ENGINE_JOBS jobs at its period, each a replay of the steps' graphs
    captured beforehand with every pinned matmul traced
    (:func:`traced_graphs`); the kernels' counts set to 0 just before and
    read just after.  The run freezes the collector's view of what lives
    before it (the model, the engine, the graphs): a full collection in a
    job then walks only what the jobs made.  Returns the executor's stats
    and trace, the :class:`GraphTrace`, the graphs' replays, each job's R
    (ms) and its own prefill and mean decode step (CUDA events, ms) and
    the ms the collector ran in it (host clock)."""
    import torch
    from repro_torch.runtime import WallClockExecutor
    from repro_torch.sched import EventTrace

    trace = EventTrace(us_per_unit=1e6, label=spec.name)
    executor = WallClockExecutor([engine.rt_service(spec, prompt)], trace=trace)
    walls, generate = [], engine.generate
    collector = {"start": 0.0, "ms": 0.0}

    def on_gc(phase, _info):
        if phase == "start":
            collector["start"] = time.perf_counter()
        else:
            collector["ms"] += (time.perf_counter() - collector["start"]) * 1e3

    def timed(*args, **kw):
        collector["ms"] = 0.0
        out, st = generate(*args, **kw)
        walls.append((st["prefill_s"] * 1e3, st["decode_s_per_tok"] * 1e3, collector["ms"]))
        return out, st

    with traced_graphs(engine, GraphTrace(engine.cfg, gn)) as graph_trace:
        prefill, decode = engine.steps(PROMPT, (gn, 0)).graphs
        captured = dict(engine._graphs)
        counters = zeroed_counters()
        t0 = time.perf_counter()
        gc.freeze()
        gc.callbacks.append(on_gc)
        try:
            with mock.patch.object(engine, "generate", timed):
                stats = executor.run((ENGINE_JOBS - 0.5) * spec.period_ms / 1e3)[spec.name]
        finally:
            gc.callbacks.remove(on_gc)
            gc.unfreeze()
        counts = {k: fn.launches for k, fn in counters.items()}
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        replays = {"prefill": prefill.replays, "decode": decode.replays}
        check(engine._graphs == captured, f"{spec.name}: a job under the executor captured "
              f"graphs: {sorted(engine._graphs)} after, {sorted(captured)} before")
    responses = [dict(e.meta)["response_s"] * 1e3 for e in trace.events if e.kind == "complete"]
    return {"stats": stats, "trace": trace, "graph_trace": graph_trace, "replays": replays,
            "counts": counts, "responses": responses, "walls": walls, "seconds": seconds}


def phase_engine(engine, ac, spec, prompt, gn: int, per_round: dict) -> dict:
    """The admitted service alone under the port's ``WallClockExecutor``:
    ``ENGINE_JOBS`` whole jobs (one ``generate`` each: a prefill and
    NEW_TOKENS decode steps), released every period, every pinned matmul
    traced and held to the GN SMs, the kernels' counts set to 0 just before
    and read just after.  The port's ``BoundMonitor`` then reads the run
    (``executor_events``: each job's R in ms against the controller's
    certified R^): no ``bound_violation`` and no ``deadline_miss``, and
    every R <= R^.  Last, the port's ``simulate`` over the controller's
    admitted set for SIM_PERIODS periods, seed 0, must miss nothing."""
    from repro_torch.obs import BoundMonitor
    from repro_torch.runtime import simulate
    from repro_torch.runtime.task_spec import job_response_ms, measured_task_to_rt
    from repro_torch.serving.engine import executor_events

    name = spec.name
    run = run_jobs(engine, spec, prompt, gn)
    stats, trace, counts = run["stats"], run["trace"], run["counts"]
    responses, walls, seconds = run["responses"], run["walls"], run["seconds"]
    graph_trace, replays = run["graph_trace"], run["replays"]
    r_hat, held = engine.rt_bound
    # R^ with the host's part at the largest one measured, not its pWCET:
    # what the extrapolation carries; and R^ under the pooled rule
    cal = engine.rt_calibration
    far = dataclasses.replace(spec, deadline_ms=1e9, period_ms=2e9)
    largest = max(float(cal.host_parts_ms(m).max()) for m in cal.host_pwcets_ms())
    r_hat_largest = job_response_ms(measured_task_to_rt(
        far, cal.fit(), max(largest, 0.0) / NEW_TOKENS, cal.prefill_ms()), gn)
    pooled = job_response_ms(pooled_task(far, cal), gn)
    for i, (r, (pre, step, gc_ms)) in enumerate(zip(responses, walls)):
        print(f"[engine] {name}: job {i}: R {r:.3f} ms {'<=' if r <= r_hat else '>'} R^ "
              f"{r_hat:.3f} ms (D {spec.deadline_ms:.3f} ms), headroom {1 - r / r_hat:.4f}; "
              f"R^ at the largest host part of {len(cal.job_ms)} calibration jobs "
              f"({largest:.3f} ms) instead of the host bound ({cal.host_bound_ms():.3f} ms) "
              f"{r_hat_largest:.3f} ms, headroom {1 - r / r_hat_largest:.4f}; the pooled rule's "
              f"R^ {pooled:.3f} ms, headroom {1 - r / pooled:.4f}; prefill {pre:.3f} ms, decode "
              f"{step:.3f} ms/step (CUDA events); the collector ran {gc_ms:.1f} ms")
    jobs = stats["completed"]
    check(stats["released"] == jobs >= ENGINE_JOBS,
          f"{name}: the executor released {stats['released']} jobs and completed {jobs}, "
          f"{ENGINE_JOBS} asked")
    want = {k: v * jobs for k, v in per_round.items()}
    check(counts == want, f"{name}: executor jobs launched {counts}, the path gives {want}")
    check(replays == {"prefill": jobs, "decode": jobs * NEW_TOKENS},
          f"{name}: {replays} graph replays in {jobs} jobs")
    traced = sum(replays["decode" if s[0] == BATCH else "prefill"]
                 for s, *_ in graph_trace.launches)
    check(traced == counts["persistent_matmul"],
          f"{name}: {traced} traced matmuls replayed, {counts['persistent_matmul']} launches")
    check_on_gn(graph_trace, replays, f"{name} executor job")

    check(held == gn, f"{name}: holds GN={held} under the executor, granted {gn}")
    monitor = BoundMonitor().feed(executor_events(trace, {name: engine.rt_bound}))
    health, alerts = monitor.tasks[name], monitor.alert_counts()
    check(health.jobs == jobs == len(responses) and health.bound == r_hat,
          f"{name}: the monitor read {health.jobs} jobs against R^ {health.bound}")
    check(not alerts.get("bound_violation") and not alerts.get("deadline_miss"),
          f"{name}: the monitor raised {alerts}")
    check(max(responses) <= r_hat, f"{name}: observed R {max(responses):.3f} ms > R^ "
          f"{r_hat:.3f} ms")
    task = engine.rt_task
    prefill_gn = max(engine.rt_calibration.measured[gn]["prefill_ms"])
    print(f"[engine] {name}: {jobs} jobs on SMs 0..{gn - 1} in {seconds:.1f} s, period "
          f"{spec.period_ms:.3f} ms; monitor: min headroom {health.min_headroom:.4f}, worst R "
          f"{health.worst_response:.3f} ms, alerts {alerts or 'none'}; launches {counts} "
          f"({replays['prefill']} prefill and {replays['decode']} decode replays), every pinned "
          f"matmul on the {gn} SMs at every replay; prefill wall on GN {prefill_gn:.3f} ms beside "
          f"CPU segment 0 {task.cpu_hi[0]:.4f} ms")

    ts, alloc = ac.current_taskset(), ac.current_alloc_list()
    horizon = SIM_PERIODS * spec.period_ms
    sims = {case: simulate(ts, alloc, horizon=horizon, seed=0, worst_case=case == "at bounds")
            for case in ("sampled", "at bounds")}
    i = [t.name for t in ts].index(name)
    for case, sim in sims.items():
        check(not sim.any_miss, f"{name}: the simulator ({case}) missed {sim.misses}")
        # sporadic releases: the first within a period, each gap up to 1.2 periods
        check(sim.jobs[i] >= SIM_PERIODS // 2, f"{name}: the simulator ({case}) ran "
              f"{sim.jobs[i]} jobs in {SIM_PERIODS} periods")
    worst = {case: {t.name: sim.max_response(j) for j, t in enumerate(ts)}
             for case, sim in sims.items()}
    print(f"[engine] {name}: simulate over the admitted set {alloc}, {horizon:.0f} ms "
          f"({SIM_PERIODS} periods), seed 0: {sims['sampled'].jobs[i]} and "
          f"{sims['at bounds'].jobs[i]} jobs, no miss; worst response {name} "
          f"{worst['sampled'][name]:.3f} ms (segments sampled), "
          f"{worst['at bounds'][name]:.3f} ms (segments at their bounds), against the card's "
          f"worst R {max(responses):.3f} ms and R^ {r_hat:.3f} ms")
    return {"jobs": jobs, "responses_ms": responses, "r_hat_ms": r_hat,
            "largest_host_part_ms": largest, "host_bound_ms": cal.host_bound_ms(),
            "r_hat_at_largest_host_part_ms": r_hat_largest, "pooled_r_hat_ms": pooled,
            "deadline_ms": spec.deadline_ms, "period_ms": spec.period_ms,
            "job_walls_ms": walls, "min_headroom": health.min_headroom, "alerts": alerts,
            "launches": counts,
            "seconds": seconds, "prefill_on_gn_ms": prefill_gn, "cpu_segment0_ms": task.cpu_hi[0],
            "sim_jobs": {c: s.jobs for c, s in sims.items()},
            "sim_worst_ms": worst}


def run_path(cfg, kernels_phase, n_sms) -> dict:
    """One model's kernels, main path, profile and RT phases; frees the
    engine before it returns."""
    import torch

    out = {"kernels": kernels_phase(cfg, n_sms), "main": phase_main_path(cfg)}
    engine, prompt = out["main"].pop("engine"), out["main"].pop("prompt")
    out["profile"] = phase_profile(engine, prompt)
    out["rt"] = phase_rt(cfg, engine, prompt, n_sms, out["main"]["rounds"][-1]["decode_s_per_tok"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def jamba_one_period():
    """jamba-v0.1-52b at full width, cut in depth to one period."""
    from repro_torch.configs import get_config

    full = get_config("jamba-v0.1-52b")
    cut = dataclasses.replace(full, n_repeats=1)
    print(f"[jamba] cut: n_repeats {full.n_repeats} -> 1 ({full.n_layers} -> {cut.n_layers} "
          f"layers): {full.param_count() * 2 / 1e9:.1f} GB of bf16 weights exceed the card's "
          f"80 GB; one period holds {cut.param_count() * 2 / 1e9:.1f} GB; every width as "
          f"published")
    return cut


def kernels_line(paths: list[dict]) -> dict:
    def total(key, rows):
        return sum(r["calls"] * r[key] for r in rows)

    def entry(name, rows_key, err_key, replaces):
        rows = [r for p in paths for r in p["kernels"][rows_key]]
        errs = [p["kernels"][err_key] for p in paths if err_key in p["kernels"]]
        has_library = all(r["library_ms"] is not None for r in rows)
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(p["main"]["launches"][name] for p in paths),
            "max_abs_err": max(errs),
            "ms": total("ms", rows), "plain_ms": total("plain_ms", rows),
            "bound_ms": total("bound_ms", rows),
            "bound_by": ("bytes" if total("bytes_ms", rows) >= total("ops_ms", rows)
                         else "operations"),
            "library_ms": total("library_ms", rows) if has_library else None,
        }

    return {"kernels": [
        entry("persistent_matmul", "matmul_rows", "matmul_err",
              "src/repro/kernels/persistent_matmul.py:59"),
        entry("flash_attention", "flash_rows", "flash_err",
              "src/repro/kernels/flash_attention.py:85"),
        entry("selective_scan", "scan_rows", "scan_err",
              "src/repro/kernels/selective_scan.py:45"),
    ]}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    report: dict = {}
    t0 = time.perf_counter()
    try:
        report["device"] = phase_device()
        report["build"] = phase_build()
        sms = report["device"]["sms"]
        report["analysis"] = phase_analysis(sms, report["device"]["nvidia_smi"])
        report["fig4"] = phase_fig4(report["device"]["nvidia_smi"])
        report["fig6"] = phase_fig6(report["device"]["nvidia_smi"], sms)
        report["qwen3-0.6b"] = run_path(get_config("qwen3-0.6b"), phase_kernels_qwen, sms)
        report["jamba-v0.1-52b"] = run_path(jamba_one_period(), phase_kernels_jamba, sms)
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    line = kernels_line([report["qwen3-0.6b"], report["jamba-v0.1-52b"]])
    report["kernels_line"] = line
    report["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
