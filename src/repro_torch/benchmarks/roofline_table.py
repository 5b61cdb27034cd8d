"""The port's roofline table, read from results/dryrun_torch/*.json (the
records of ``python -m repro_torch.launch.dryrun``); counterpart of the
JAX package's ``benchmarks/roofline_table.py``.

Prints per (arch x shape x mesh): the three terms in seconds, the dominant
bottleneck, MODEL_FLOPS over the counted FLOPs, per-device peak bytes,
and a one-line "what would move the dominant term" hint in the port's
levers.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""
from __future__ import annotations

import json
import pathlib

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = ("16x16", "2x16x16")

_HINTS = {
    "compute_s": "keep the bf16 products on the tensor cores (wgmma matmul/flash), "
                 "recompute less in backward",
    "memory_s": "fuse the eager step's small ops into hand kernels / recompute activations "
                "in backward (train)",
    "collective_s": "re-shard to cut all-gathers (expand-KV GQA layout, seq-parallel residual)",
}


def load_records() -> list[dict]:
    out = []
    for f in sorted(RESULTS.glob("*.json")):
        try:
            out.append(json.loads(f.read_text()))
        except (OSError, json.JSONDecodeError):
            pass
    return out


def run(rows: list | None = None, mesh: str = "16x16") -> list:
    rows = rows if rows is not None else []
    recs = [r for r in load_records() if r.get("mesh") == mesh]
    ok = [r for r in recs if r.get("status") == "ok"]
    rows.append((f"roofline_{mesh}_combos_ok", len(ok)))
    rows.append((
        f"roofline_{mesh}_combos_failed",
        len([r for r in recs if r.get("status") == "FAILED"]),
    ))
    for r in ok:
        tag = f"{r['arch']}|{r['shape']}"
        rl = r["roofline"]
        rows.append((f"roofline[{tag}]_compute_s", rl["compute_s"]))
        rows.append((f"roofline[{tag}]_memory_s", rl["memory_s"]))
        rows.append((f"roofline[{tag}]_collective_s", rl["collective_s"]))
        rows.append((f"roofline[{tag}]_dominant", rl["dominant"]))
        rows.append((f"roofline[{tag}]_useful_flops_ratio",
                     rl.get("useful_flops_ratio")))
        rows.append((f"roofline[{tag}]_peak_gb",
                     r["memory"]["peak_bytes"] / 1e9))
    return rows


def markdown_table(mesh: str | None = None) -> str:
    """The table of one mesh, or of both meshes (``MESHES``) one after the
    other when ``mesh`` is None."""
    if mesh is None:
        return "\n\n".join(markdown_table(m) for m in MESHES)
    recs = [r for r in load_records() if r.get("mesh") == mesh]
    lines = [
        f"Mesh {mesh}:",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant | useful FLOPs | peak GB/dev | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | "
                         f"{r.get('reason', '')} |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | FAILED | — | — | "
                         f"{r.get('error', '')[:40]} |")
            continue
        rl = r["roofline"]
        ur = rl.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3e} | "
            f"{rl['memory_s']:.3e} | {rl['collective_s']:.3e} | "
            f"{rl['dominant'].replace('_s', '')} | "
            f"{ur:.2f} | {r['memory']['peak_bytes'] / 1e9:.1f} | "
            f"{_HINTS[rl['dominant']]} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table())
