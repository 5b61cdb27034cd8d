#!/usr/bin/env python3
"""Whole-job walls of one served shape after a capture and after profiler windows.

    python3 scripts/host_regimes.py [--jobs 40] [--gn 49]

On one H100: serves full-width qwen3-0.6b (random weights, seed 0; batch
4, 256-token prompts, 16 greedy tokens) with its steps' graphs captured
on ``--gn`` SMs, and times whole jobs (one ``generate`` each, a
synchronise on both sides, as ``ServingEngine.measure_decode`` times the
calibration's) in six runs: after the capture; again; after six profiled
decode steps (``serving.engine.profiled_ms``, as the calibration profiles
them); again; after a capture on other SMs; after six profiled steps and
5 s idle.  Each run prints its first walls and means over jobs 0-9, 10-19
and 20 on, beside the card's name and power limit.  It writes
``chiprun_out/host_regimes.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=40)
    ap.add_argument("--gn", type=int, default=49)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("host_regimes.py: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.engine import profiled_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    _build.build_all()
    cfg = get_config("qwen3-0.6b")
    engine = ServingEngine(cfg, ServeConfig(max_context=512, batch=4), seed=0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 256)).astype(np.int32)
    engine.generate(prompt, max_new_tokens=16)
    held = (args.gn, 0)
    engine.capture(256, held)

    def jobs(n: int) -> list[float]:
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._generate(prompt, 16, None, held)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    def profile_steps() -> None:
        for _ in range(6):
            profiled_ms(engine.steps(256, held).decode)

    runs = {}

    def run(what: str, before=None) -> None:
        if before is not None:
            before()
        w = np.array(jobs(args.jobs))
        runs[what] = w.tolist()
        print(f"[regimes] {what}: first 5 {np.round(w[:5], 2).tolist()} ms; mean of jobs 0-9 "
              f"{w[:10].mean():.3f}, 10-19 {w[10:20].mean():.3f}, 20 on {w[20:].mean():.3f}; "
              f"min {w.min():.3f}, max {w.max():.3f} ms", flush=True)

    run(f"after the capture on {args.gn} SMs")
    run("again")
    run("after 6 profiled decode steps", profile_steps)
    run("again")
    run("after a capture on 33 SMs", lambda: engine.capture(256, (33, 0)))
    run("after 6 profiled decode steps and 5 s idle",
        lambda: (profile_steps(), time.sleep(5.0)))
    out = ROOT / "chiprun_out" / "host_regimes.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "gn": args.gn, "walls_ms": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
