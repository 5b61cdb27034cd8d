#!/usr/bin/env python3
"""Time the flash attention route of two checkouts on one card, in turns.

    python3 scripts/flash_ab.py --base DIR [--out FILE]

DIR is another checkout of the repository (for example ``git archive`` of
the parent commit, unpacked into a directory that .gitignore lists).  At
the prefill shape of both main paths (qwen3-0.6b: 4 x 256 tokens, 16 query
and 8 KV heads of 128; jamba-v0.1-52b: 32 and 8), this script times, in
separate processes in the order base, change, change, base, each with
``chip_smoke.time_ms`` (CUDA-graph replay):
- ``ops.mha_flash`` on q [B, S, H, hd] and k/v [B, S, Hkv, hd], the call
  the model makes (with whatever copies each checkout makes around its
  kernel);
- ``flash_attention`` on [B*H, S, hd] inputs already expanded to the query
  heads (the kernel alone, without the copies a caller would make);
- ``scaled_dot_product_attention`` on [B, H, S, hd] views of the same
  tensors (causal, GQA), a yardstick the port never calls.
It prints each version's mean of its two runs and writes every run to FILE
(by default flash_ab.json in chip_smoke.py's output directory).  Needs one
card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"qwen3-0.6b": (4, 256, 16, 8, 128), "jamba-v0.1-52b": (4, 256, 32, 8, 128)}


def worker(checkout: Path) -> dict:
    """Times in this process, of ``checkout``'s ``repro_torch``: call before
    anything else imports it."""
    sys.path.insert(0, str(checkout / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (b, s, h, hkv, hd) in SHAPES.items():
        q, k, v = chip_smoke.flash_inputs(b, s, h, hkv, hd, torch.bfloat16, gen)
        qf, kf, vf = (chip_smoke.expand_heads(t, h) for t in (q, k, v))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        scale = hd ** -0.5
        out[name] = {
            "mha_flash_ms": chip_smoke.time_ms(lambda: ops.mha_flash(q, k, v, scale=scale)),
            "expanded_ms": chip_smoke.time_ms(lambda: flash_attention(qf, kf, vf, scale=scale)),
            "sdpa_ms": chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True)),
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path)
    ap.add_argument("--worker", type=Path)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if a.worker is not None:
        print(json.dumps(worker(a.worker)))
        return 0
    if a.base is None:
        ap.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        print("flash_ab.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for name, path in (("base", a.base), ("change", ROOT), ("change", ROOT), ("base", a.base)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(path.resolve())],
                             capture_output=True, text=True, check=True).stdout
        runs.append({"name": name, "times": json.loads(out.strip().splitlines()[-1])})

    def mean(name, shape, key):
        vals = [r["times"][shape][key] for r in runs if r["name"] == name]
        return sum(vals) / len(vals)

    for shape, (b, s, h, hkv, hd) in SHAPES.items():
        line = f"{shape} B={b} S={s} H={h}/{hkv} hd={hd}:"
        for key in ("mha_flash_ms", "expanded_ms", "sdpa_ms"):
            base, change = mean("base", shape, key), mean("change", shape, key)
            line += f" {key} base {base:.4f} change {change:.4f} ({base / change:.2f}x);"
        print(line)
    out_path = a.out or ROOT / "chiprun_out" / "flash_ab.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
