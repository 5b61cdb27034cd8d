#!/usr/bin/env python3
"""Time the pinned matmul's wgmma variant at every K split of a shape.

    python3 scripts/wgmma_split_sweep.py [--out FILE]

``persistent_matmul.split_plan`` chooses the slice count from the shape
alone, with a cost model whose constant WGMMA_PARTIAL_ROWS (the traffic of
a split unit's float32 partial) was fitted to these times.  For each wide
bf16 prefill shape of the two main paths that has fewer 128 x 128 tiles
than the card has lanes, this script forces each slice count in turn
(slices of whole 64-deep K steps), checks the result against the plain
version and its bit-identity at 1 and all SMs, and times it with
``chip_smoke.time_ms`` (CUDA-graph replay over a ring of weights larger
than the L2) beside ``torch.matmul``; the plan's own choice is marked.  A
one-tile launch gives the variant's fixed cost.  Writes every row to FILE
(by default wgmma_split_sweep.json in chip_smoke.py's output directory).
Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (M, K, N) and the slice counts to force; the first is a one-tile launch
SHAPES = [((128, 64, 128), (1,)),
          ((1024, 1024, 1024), (1, 2, 4)), ((1024, 1024, 2048), (1, 2)),
          ((1024, 1024, 3072), (1, 2)), ((1024, 2048, 1024), (1, 2, 3, 4)),
          ((1024, 3072, 1024), (1, 2, 3, 4)), ((1024, 4096, 1024), (1, 2, 3, 4, 8)),
          ((1024, 4096, 4096), (1, 2))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("wgmma_split_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import persistent_matmul as pm
    from repro_torch.kernels.ref import matmul_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.build_all()
    bf16, plan = torch.bfloat16, pm.split_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    for (m, k, n), slice_counts in SHAPES:
        assert pm.kernel_name(m, k, n, bf16) == "pinned_wgmma_kernel"
        chosen = plan(m, k, n, 2)[:2]
        x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
        n_w = max(2, int(120e6 // (k * n * 2)) + 1)
        args = [(x, (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(bf16))
                for _ in range(n_w)]
        iters = max(20, n_w)
        want = matmul_ref(*args[0]).float()
        library_ms = chip_smoke.time_ms(chip_smoke.cycling(torch.matmul, args), iters)
        for s in slice_counts:
            steps = -(-k // pm.WGMMA_K)
            slice_len = -(-steps // s) * pm.WGMMA_K
            forced = (-(-k // slice_len), slice_len, pm.WGMMA_K)
            pm.split_plan = lambda *_, forced=forced: forced
            try:
                outs = [pm.persistent_matmul(*args[0], n_bands=b) for b in (1, None)]
                right = torch.equal(outs[0], outs[1]) and torch.allclose(
                    outs[1].float(), want, rtol=chip_smoke.MATMUL_BF16_TOL,
                    atol=chip_smoke.MATMUL_BF16_TOL)
                ms = chip_smoke.time_ms(chip_smoke.cycling(pm.persistent_matmul, args), iters)
            finally:
                pm.split_plan = plan
            ok &= right
            row = {"m": m, "k": k, "n": n, "slices": forced[0], "slice_len": slice_len,
                   "plan": forced[:2] == chosen, "right": right, "ms": ms,
                   "library_ms": library_ms}
            rows.append(row)
            print(f"M={m} K={k} N={n} slices {forced[0]} of {slice_len}"
                  f"{' (the plan)' if row['plan'] else ''}: {ms:.4f} ms, torch.matmul "
                  f"{library_ms:.4f} ({ms / library_ms:.2f}x){'' if right else ' WRONG'}")
        del args
    out_file = a.out or chip_smoke.OUT_DIR / "wgmma_split_sweep.json"
    out_file.parent.mkdir(exist_ok=True)
    out_file.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
