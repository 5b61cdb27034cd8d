#!/usr/bin/env python3
"""Time the pinned matmul of two checkouts on one card, in turns.

    python3 scripts/matmul_ab.py --base DIR [--out FILE]

DIR is another checkout of the repository (for example ``git archive`` of
the parent commit, unpacked into a directory that .gitignore lists).  At
every (M, K, N, dtype) that ``chip_smoke.py`` counts on the two main paths
(qwen3-0.6b, and jamba-v0.1-52b cut to one period), this script times the
kernel of DIR and of this checkout in separate processes, in the order
base, change, change, base, each with ``chip_smoke.time_ms`` (CUDA-graph
replay over a ring of weights larger than the L2), beside ``torch.matmul``.
It prints one line per shape (each version's mean of its two runs, and the
CUDA kernel that this checkout's variant choice gives the shape) and the
path totals (ms per launch times launches), and writes every run to FILE
(by default matmul_ab.json in chip_smoke.py's output directory).  Needs
one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def shapes() -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.configs import get_config

    calls: dict = {}
    for cfg in (get_config("qwen3-0.6b"),
                dataclasses.replace(get_config("jamba-v0.1-52b"), n_repeats=1)):
        for key, n in chip_smoke.matmul_calls(cfg).items():
            calls[key] = calls.get(key, 0) + n
    return calls


def worker(checkout: Path, keys: list) -> list:
    """Times in this process: the kernel of ``checkout`` and torch.matmul.
    Imports ``repro_torch`` from ``checkout`` only: call before anything
    else imports it."""
    sys.path.insert(0, str(checkout / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.persistent_matmul import persistent_matmul

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for m, k, n, dt_name in keys:
        dt = getattr(torch, dt_name)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        n_w = max(2, int(120e6 // (k * n * x.element_size())) + 1)
        args = [(x, (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dt))
                for _ in range(n_w)]
        iters = max(20, n_w)
        rows.append({"m": m, "k": k, "n": n, "dtype": dt_name,
                     "ms": chip_smoke.time_ms(chip_smoke.cycling(persistent_matmul, args), iters),
                     "library_ms": chip_smoke.time_ms(chip_smoke.cycling(torch.matmul, args),
                                                      iters)})
        del args
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path)
    ap.add_argument("--worker", type=Path)
    ap.add_argument("--keys", help="the worker's shapes, as JSON")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if a.worker is not None:
        print(json.dumps(worker(a.worker, [tuple(key) for key in json.loads(a.keys)])))
        return 0
    calls = shapes()
    keys = sorted(calls)
    if a.base is None:
        ap.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        print("matmul_ab.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for name, path in (("base", a.base), ("change", ROOT), ("change", ROOT), ("base", a.base)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(path.resolve()),
                              "--keys", json.dumps(keys)],
                             capture_output=True, text=True, check=True).stdout
        runs.append({"name": name, "rows": json.loads(out.strip().splitlines()[-1])})

    def mean(name, i, key):
        vals = [r["rows"][i][key] for r in runs if r["name"] == name]
        return sum(vals) / len(vals)

    from repro_torch.kernels.persistent_matmul import kernel_name
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32

    totals = {"base": 0.0, "change": 0.0, "library": 0.0, "bound": 0.0}
    table = []
    for i, (m, k, n, dt) in enumerate(keys):
        eb = 4 if dt == "float32" else 2
        n_bytes = (m * k + k * n + m * n) * eb
        peak = PEAK_FLOPS_F32 if dt == "float32" else PEAK_FLOPS
        bound = max(n_bytes / HBM_BW, 2.0 * m * n * k / peak) * 1e3
        row = {"m": m, "k": k, "n": n, "dtype": dt, "calls": calls[(m, k, n, dt)],
               "kernel": kernel_name(m, k, n, getattr(torch, dt)),
               "base_ms": mean("base", i, "ms"), "change_ms": mean("change", i, "ms"),
               "library_ms": mean("change", i, "library_ms"), "bound_ms": bound,
               "change_gb_s": n_bytes / mean("change", i, "ms") / 1e6}
        table.append(row)
        for key, col in (("base", "base_ms"), ("change", "change_ms"),
                         ("library", "library_ms"), ("bound", "bound_ms")):
            totals[key] += row["calls"] * row[col]
        print(f"M={m} K={k} N={n} {dt} x{row['calls']} ({row['kernel']}): base "
              f"{row['base_ms']:.4f} change "
              f"{row['change_ms']:.4f} ms ({row['change_gb_s']:.0f} GB/s), torch.matmul "
              f"{row['library_ms']:.4f}, bound {bound:.4f}; runs "
              + " ".join(f"{r['name']} {r['rows'][i]['ms']:.4f}" for r in runs))
    print(f"path totals (ms): {json.dumps(totals)}")
    import chip_smoke

    out_file = a.out or chip_smoke.OUT_DIR / "matmul_ab.json"
    out_file.parent.mkdir(exist_ok=True)
    out_file.write_text(json.dumps({"nvidia_smi": smi, "runs": runs, "table": table,
                                 "totals": totals}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
