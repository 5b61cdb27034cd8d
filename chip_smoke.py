#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the repository root and imports only ``repro_torch`` (from
``src/``).  Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: both hand kernels with nvcc into ``build/``, timed;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: persistent_matmul (bf16 and f32, n_bands in {1, 8, all
   SMs}: tile coverage, the allocated-SM check, bit-identity across band
   counts) and flash_attention (prefill shape, sliding window, ragged S);
   each kernel's device time (CUDA-graph replay) beside its plain version,
   a library yardstick and its bound, and its time when issued eagerly;
4. main path: full-width qwen3-0.6b in bf16 (random weights from a seed)
   through ``ServingEngine.generate``, two rounds of 4 requests of 256
   prompt tokens and 16 greedy tokens, with the kernels' launch counts;
   then the prefill logits against the same model on the plain versions,
   both held to a float32 run of the plain versions;
5. profile: device time by kernel and the device's idle share over one
   prefill and eight decode steps (torch.profiler);
6. RT bridge: the measured decode step as an RTGPU task.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

BATCH, PROMPT, NEW_TOKENS, ROUNDS, MAX_CONTEXT = 4, 256, 16, 2, 512
SEED = 0
# Tolerances, kernel vs plain version on the same inputs:
MATMUL_F32_TOL = 1e-4    # abs, outputs of unit scale; both accumulate in f32 (no TF32)
MATMUL_BF16_TOL = 1e-2   # rtol = atol: one bf16 ulp (<= 2**-7 relative) from f32 sums
FLASH_F32_TOL = 2e-4     # as tests/test_kernels.py for f32 attention
FLASH_BF16_TOL = 3e-2    # as tests/test_kernels.py for bf16 attention
# Prefill logits of 28 bf16 layers: the kernel path may differ from the plain
# path, and from a float32 run of the plain path, by at most this many times
# the plain bf16 path's own relative L2 error against that float32 run.
LOGITS_NOISE_FACTOR = 2.0


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

    return _events_ms(replays, reps * iters)


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


def bound(n_bytes: float, flops: float) -> dict:
    """Least time for the work: bytes over HBM rate or bf16 FLOPs over the
    tensor-core peak, whichever is larger (H100 SXM data sheet)."""
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS

    t_bytes, t_ops = n_bytes / HBM_BW * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return {"seconds": seconds, "nvcc": logs}


def proj_shapes(cfg) -> list[tuple[int, int]]:
    """(K, N) of one layer's projections, in call order."""
    d, q, kv, ff = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
    return [(d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d)]


def check_matmul(m, k, n, dtype, gen, n_sms) -> float:
    import torch
    from repro_torch.kernels.persistent_matmul import (
        persistent_matmul, persistent_matmul_traced, tile_grid)
    from repro_torch.kernels.ref import matmul_ref

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dtype)
    want = matmul_ref(x, w)
    outs = []
    for n_bands in (1, 8, n_sms):
        got, trace = persistent_matmul_traced(x, w, n_bands)
        torch.cuda.synchronize()
        _, _, total, per_lane = tile_grid(m, n, n_bands)
        hits = trace.tile_hits.cpu()
        check(trace.tiles_done == total and bool((hits == 1).all()),
              f"matmul {m}x{k}x{n} n_bands={n_bands}: {trace.tiles_done} of {total} "
              f"tiles done, hits {hits.min().item()}..{hits.max().item()}")
        owner = torch.tensor([trace.allowed_sms[t // (2 * per_lane)] for t in range(total)],
                             dtype=torch.int32)
        check(torch.equal(trace.tile_sm.cpu(), owner),
              f"matmul {m}x{k}x{n} n_bands={n_bands}: a tile ran off its band's SM")
        outs.append(got)
    for n_bands, o in zip((8, n_sms), outs[1:]):
        check(torch.equal(o, outs[0]),
              f"matmul {m}x{k}x{n} {dtype}: n_bands={n_bands} differs from n_bands=1")
    check(torch.equal(persistent_matmul(x, w), outs[0]), "untraced launch differs")
    err = (outs[0].float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok = err <= MATMUL_F32_TOL * max(1.0, want.abs().max().item())
    else:
        ok = torch.allclose(outs[0].float(), want.float(), rtol=MATMUL_BF16_TOL,
                            atol=MATMUL_BF16_TOL)
    check(ok, f"matmul {m}x{k}x{n} {dtype}: max abs err {err}")
    return err


def check_flash(b, s, h, hkv, hd, dtype, window, gen) -> float:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    q = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    got = ops.mha_flash(q, k, v, scale=hd ** -0.5, window=window)
    with mock.patch.object(ops, "flash_attention", flash_attention_ref):
        want = ops.mha_flash(q, k, v, scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()) and
          torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"flash b={b} s={s} h={h}/{hkv} hd={hd} {dtype} window={window}: "
          f"max abs err {err}")
    return err


def phase_kernels(cfg, n_sms) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.persistent_matmul import persistent_matmul
    from repro_torch.kernels.ref import flash_attention_ref, matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, cfg.dtype)
    ms_path = (BATCH * PROMPT, BATCH)
    shapes = sorted(set(proj_shapes(cfg)))

    # correctness
    mm_err = {}
    for m in ms_path:
        for k, n in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                mm_err[(m, k, n, str(dtype))] = check_matmul(m, k, n, dtype, gen, n_sms)
    ragged = [(m, 200, n, dtype) for m in (3, 16, 100) for n in (130, 136)
              for dtype in (torch.float32, torch.bfloat16)]
    for m, k, n, dtype in ragged:  # ragged edges, every tile variant, scalar and vector loads
        check_matmul(m, k, n, dtype, gen, n_sms)
    print(f"[kernels] persistent_matmul: {len(mm_err) + len(ragged)} shapes x 3 band counts ok; "
          f"max abs err bf16 {max(v for key, v in mm_err.items() if 'bfloat16' in key[3]):.3g}, "
          f"f32 {max(v for key, v in mm_err.items() if 'float32' in key[3]):.3g}")
    hd = cfg.head_dim
    fl_err = check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, dt, None, gen)
    fl_extra = {
        "window64_bf16": check_flash(BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, dt, 64, gen),
        "f32": check_flash(2, PROMPT, 4, 2, hd, torch.float32, None, gen),
        "f32_window64_ragged_hd64": check_flash(2, 200, 4, 2, 64, torch.float32, 64, gen),
        "f32_hd32_ragged": check_flash(1, 77, 2, 1, 32, torch.float32, None, gen),
        "bf16_window64_ragged_hd64": check_flash(2, 200, 4, 2, 64, torch.bfloat16, 64, gen),
        "bf16_hd32_ragged": check_flash(1, 77, 2, 1, 32, torch.bfloat16, None, gen),
    }
    print(f"[kernels] flash_attention ok: max abs err {fl_err:.3g} (path), {fl_extra}")

    # timing at the path's shapes, in the path's dtype, on all SMs
    calls_prefill = cfg.n_layers * ROUNDS
    calls_decode = cfg.n_layers * ROUNDS * NEW_TOKENS
    rows = []
    for m, calls_per_shape in ((BATCH * PROMPT, calls_prefill), (BATCH, calls_decode)):
        for k, n in proj_shapes(cfg):
            x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
            n_w = max(2, int(120e6 // (k * n * x.element_size())) + 1)
            ws = [(torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dt)
                  for _ in range(n_w)]
            args = [(x, w) for w in ws]
            iters = max(20, n_w)  # one graph walks the whole ring
            eb = x.element_size()
            rows.append({
                "m": m, "k": k, "n": n, "calls": calls_per_shape,
                "ms": time_ms(cycling(persistent_matmul, args), iters),
                "eager_ms": eager_ms(cycling(persistent_matmul, args)),
                "plain_ms": time_ms(cycling(matmul_ref, args), iters),
                "library_ms": time_ms(cycling(torch.matmul, args), iters),
                **bound((m * k + k * n + m * n) * eb, 2.0 * m * n * k),
            })
            del ws, args
    for r in rows:
        print(f"[kernels] matmul M={r['m']} K={r['k']} N={r['n']}: {r['ms']:.4f} ms "
              f"(issued eagerly {r['eager_ms']:.4f}; plain {r['plain_ms']:.4f}, "
              f"torch.matmul {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']})")

    bh = BATCH * cfg.n_heads
    qf, kf, vf = (torch.randn(bh, PROMPT, hd, generator=gen, device="cuda").to(dt)
                  for _ in range(3))
    q4, k4, v4 = (t.reshape(BATCH, cfg.n_heads, PROMPT, hd) for t in (qf, kf, vf))
    scale = hd ** -0.5
    flash_row = {
        "bh": bh, "s": PROMPT, "hd": hd, "calls": calls_prefill,
        "ms": time_ms(lambda: flash_attention(qf, kf, vf, scale=scale)),
        "eager_ms": eager_ms(lambda: flash_attention(qf, kf, vf, scale=scale)),
        "plain_ms": time_ms(lambda: flash_attention_ref(qf, kf, vf, scale=scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale)),
        # causal work: query i attends i+1 keys, two products of hd each
        **bound(4 * bh * PROMPT * hd * qf.element_size(),
                4.0 * hd * bh * PROMPT * (PROMPT + 1) / 2),
    }
    print(f"[kernels] flash BH={bh} S={PROMPT} hd={hd}: {flash_row['ms']:.4f} ms "
          f"(issued eagerly {flash_row['eager_ms']:.4f}; plain {flash_row['plain_ms']:.4f}, "
          f"sdpa {flash_row['library_ms']:.4f}, "
          f"bound {flash_row['bound_ms']:.4f} by {flash_row['bound_by']})")
    bf16_err = max(v for key, v in mm_err.items() if key[3] == str(dt))
    return {"matmul_rows": rows, "flash_row": flash_row,
            "matmul_err": bf16_err, "flash_err": fl_err, "flash_extra_err": fl_extra}


def phase_main_path(cfg) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.persistent_matmul import persistent_matmul
    from repro_torch.kernels.ref import flash_attention_ref, matmul_ref
    from repro_torch.serving import ServeConfig, ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, ServeConfig(max_context=MAX_CONTEXT, batch=BATCH), seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
               for _ in range(ROUNDS)]

    persistent_matmul.launches = 0
    flash_attention.launches = 0
    rounds = []
    for p in prompts:
        t1 = time.perf_counter()
        out, stats = engine.generate(p, max_new_tokens=NEW_TOKENS)
        stats["wall_s"] = time.perf_counter() - t1
        rounds.append(stats)
        check(out.shape == (BATCH, NEW_TOKENS), f"tokens shape {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token outside the vocab")
    launches = {"persistent_matmul": persistent_matmul.launches,
                "flash_attention": flash_attention.launches}
    print(f"[main] launches on the main path: {launches}")
    check(launches["persistent_matmul"] > 0 and launches["flash_attention"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    n_proj = len(proj_shapes(cfg)) * cfg.n_layers * ROUNDS
    check(launches["persistent_matmul"] == n_proj * (1 + NEW_TOKENS),
          f"matmul launches {launches['persistent_matmul']} != {n_proj * (1 + NEW_TOKENS)}")
    check(launches["flash_attention"] == cfg.n_layers * ROUNDS, "flash launches")

    model = engine.model
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts[0], device="cuda")
        got, _ = model.prefill(tokens, model.init_caches(BATCH, MAX_CONTEXT))
        with mock.patch.object(ops, "persistent_matmul", lambda x, w, n_bands=None: matmul_ref(x, w)), \
                mock.patch.object(ops, "flash_attention", flash_attention_ref):
            want, _ = model.prefill(tokens, model.init_caches(BATCH, MAX_CONTEXT))
            model32 = copy.deepcopy(model).float()
            model32.dtype = torch.float32
            truth, _ = model32.prefill(tokens, model32.init_caches(BATCH, MAX_CONTEXT))
            del model32
    got, want = got.float(), want.float()
    check(got.shape == (BATCH, 1, cfg.vocab) and bool(torch.isfinite(got).all()),
          f"prefill logits {tuple(got.shape)} not finite or mis-shaped")

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel, noise, rel_truth = rel_l2(got, want), rel_l2(want, truth), rel_l2(got, truth)
    argmax_agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    max_abs = (got - want).abs().max().item()
    check(rel <= LOGITS_NOISE_FACTOR * noise and rel_truth <= LOGITS_NOISE_FACTOR * noise,
          f"prefill logits: kernels vs plain rel L2 {rel}, vs float32 {rel_truth}; "
          f"plain bf16 vs float32 {noise} (factor {LOGITS_NOISE_FACTOR})")

    steady = rounds[-1]
    tok_s = BATCH / steady["decode_s_per_tok"]
    print(f"[main] qwen3-0.6b bf16 batch {BATCH}: prefill {steady['prefill_s'] * 1e3:.3f} ms "
          f"({BATCH}x{PROMPT} tokens), decode {steady['decode_s_per_tok'] * 1e3:.3f} ms/step, "
          f"{tok_s:.1f} tokens/s; round walls {[round(r['wall_s'], 3) for r in rounds]} s")
    print(f"[main] prefill logits rel L2: kernels vs plain {rel:.4g}, kernels vs float32 "
          f"{rel_truth:.4g}, plain bf16 vs float32 {noise:.4g}; max abs {max_abs:.3g}, "
          f"argmax agreement {argmax_agree:.3f}")
    return {"engine": engine, "prompt": prompts[0],
            "launches": launches, "rounds": rounds, "init_s": init_s,
            "logits_rel_l2": rel, "logits_rel_l2_vs_f32": rel_truth,
            "plain_bf16_rel_l2_vs_f32": noise,
            "logits_max_abs": max_abs, "argmax_agree": argmax_agree,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


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
    return {"wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy,
            "idle_share": (1.0 - busy * steps / wall_ms) if rows else None,
            "device_ops_per_step": sum(r["calls"] for r in rows) / steps,
            "top": rows[:12]}


def phase_profile(engine, prompt) -> dict:
    import torch

    model = engine.model
    out = {}
    with torch.inference_mode():
        tokens = torch.as_tensor(prompt, device="cuda")
        caches = model.init_caches(BATCH, MAX_CONTEXT)
        out["prefill"] = _profile(lambda: model.prefill(tokens, caches), 1)
        logits, caches = model.prefill(tokens, caches)
        tok = logits[:, -1].argmax(-1)[:, None]
        state = {"len": torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")}

        def step():
            model.decode_step(tok, caches, state["len"])
            state["len"] = state["len"] + 1

        step()
        out["decode"] = _profile(step, 8)
    for phase, r in out.items():
        if r["idle_share"] is None:
            print(f"[profile] {phase}: the profiler saw no device time (not measured)")
            continue
        print(f"[profile] {phase}: wall {r['wall_ms_per_step']:.3f} ms/step under the "
              f"profiler, device busy {r['device_ms_per_step']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['device_ops_per_step']:.0f} device ops/step")
        for row in r["top"][:6]:
            print(f"[profile]   {row['device_ms']:.4f} ms  x{row['calls']}  {row['name'][:90]}")
    return out


def phase_rt(cfg, decode_s: float) -> dict:
    from repro_torch.runtime import ServingTaskSpec, serving_task_to_rt

    spec = ServingTaskSpec(
        name="chat-qwen", arch_id=cfg.name, period_ms=1000.0, deadline_ms=500.0,
        batch=BATCH, seq_len=PROMPT, new_tokens=NEW_TOKENS, roofline_step_s=decode_s,
        dominant="memory_s", vocab=cfg.vocab,
    )
    task = serving_task_to_rt(spec)
    seg = task.gpu[0]
    lo, hi = seg.response_bounds(2)
    print(f"[rt] {task.name}: {task.n_gpu} GPU segments of GW=[{seg.work_lo:.4f}, "
          f"{seg.work_hi:.4f}] ms, GL={seg.overhead_hi:.4f} ms, alpha={seg.alpha}; "
          f"response on 2 virtual SMs [{lo:.4f}, {hi:.4f}] ms; "
          f"utilization(2 vSMs) {task.utilization():.4f}")
    return {"gpu_segment": vars(seg), "utilization": task.utilization()}


def kernels_line(kern: dict, main: dict) -> dict:
    rows, fr = kern["matmul_rows"], kern["flash_row"]

    def total(key, rs):
        return sum(r["calls"] * r[key] for r in rs)

    def bound_by(rs):
        return "bytes" if total("bytes_ms", rs) >= total("ops_ms", rs) else "operations"

    mm = {
        "name": "persistent_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/persistent_matmul.cu",
        "replaces": "src/repro/kernels/persistent_matmul.py:59",
        "launches": main["launches"]["persistent_matmul"],
        "max_abs_err": kern["matmul_err"],
        "ms": total("ms", rows), "plain_ms": total("plain_ms", rows),
        "bound_ms": total("bound_ms", rows),
        "bound_by": bound_by(rows),
        "library_ms": total("library_ms", rows),
    }
    fl = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": main["launches"]["flash_attention"],
        "max_abs_err": kern["flash_err"],
        "ms": total("ms", [fr]), "plain_ms": total("plain_ms", [fr]),
        "bound_ms": total("bound_ms", [fr]), "bound_by": bound_by([fr]),
        "library_ms": total("library_ms", [fr]),
    }
    return {"kernels": [mm, fl]}


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

    cfg = get_config("qwen3-0.6b")
    report: dict = {}
    t0 = time.perf_counter()
    try:
        report["device"] = phase_device()
        report["build"] = phase_build()
        report["kernels"] = phase_kernels(cfg, report["device"]["sms"])
        report["main"] = phase_main_path(cfg)
        report["profile"] = phase_profile(report["main"].pop("engine"),
                                          report["main"].pop("prompt"))
        report["rt"] = phase_rt(cfg, report["main"]["rounds"][-1]["decode_s_per_tok"])
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    line = kernels_line(report["kernels"], report["main"])
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
