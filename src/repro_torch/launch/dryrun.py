"""Dry run: count every (architecture x input shape) on the production
meshes and extract the roofline terms (counterpart of
``repro.launch.dryrun``).

No device and no memory: the model, its caches and inputs are built on the
meta device, placed on a ``DeviceMesh`` over a fake process group
(``launch.mesh``), and one step runs under ``roofline.analyze_step``.
Importing this module sets nothing; the meshes exist only inside
``run_one``.  The record says how each number was obtained:

* ``flops_total``, ``bytes_accessed`` (``count_method``): the global count
  of one eager step, divided by the chips: per device, as JAX's.
* ``collective_bytes``, ``collective_breakdown`` (``collective_method``:
  "placement rule"), output bytes per device, on mesh axes of more than
  one device:
  - each parameter sharded over "data" is all-gathered over "data" before
    use: once in a serving step, twice in a train step (forward and
    backward); the gathered tensor is its shard times the "data" split;
  - in a train step each gradient is reduce-scattered over "data" where
    its parameter is sharded over "data", else all-reduced over the batch's
    data axes; on the multi-pod mesh it is also all-reduced over "pod";
  - each product whose contracted dim of a parameter is sharded over
    "model" all-reduces its output over "model"; a device holds the rows of
    its batch split (the residual's spec, ``StepBundle.act_spec``).
* ``memory.argument_bytes``: the shards of the parameters, optimizer
  state, caches and inputs under their placements, exact;
  ``output_bytes``: the step's results (donated ones as placed, the rest
  split over the batch's data axes where their first dim is the batch);
  ``alias_bytes``: the donated arguments, which the results alias;
  ``temp_bytes``: the peak of live bytes in storages the step created
  (``OpStats.temp_peak_bytes``) over the batch's data split;
  ``peak_bytes``: JAX's formula, arguments + outputs + temps - aliases.
* ``trace_s`` in place of JAX's ``lower_s``/``compile_s``: the seconds to
  build the bundle and count its step.  There is no ``xla_cost_analysis``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape decode_32k --multi-pod
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, shape_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import StepBundle, build_bundle
from repro_torch.models.sharding import axis_sizes
from repro_torch.roofline import OpStats, analyze_step, roofline_report

__all__ = ["RESULTS_DIR", "count_step", "dry_run", "run_one", "main"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
COUNT_METHOD = ("one eager step on the meta device under roofline.analyze_step (aten "
                "formulas, hand-kernel counts, operands + results of every op), global / chips")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _split(spec, sizes: dict) -> int:
    """Devices a tensor of ``spec`` is split over."""
    return math.prod(sizes[a] for e in spec for a in _axes(e))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _per_device(tree, specs, sizes: dict) -> int:
    """Bytes per device of a tree of tensors under a matching tree of specs."""
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree) // _split(specs, sizes)
    if isinstance(tree, dict):
        return sum(_per_device(tree[k], specs[k], sizes) for k in tree)
    return sum(_per_device(t, s, sizes) for t, s in zip(tree, specs))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def count_step(cfg, shape, mesh) -> tuple[StepBundle, OpStats, float]:
    """The meta bundle of (cfg, shape) on ``mesh`` and the counts of its
    step -> (bundle, OpStats, seconds)."""
    t0 = time.perf_counter()
    bundle = build_bundle(cfg, shape, mesh)
    stats, _ = analyze_step(bundle.step_fn, *bundle.args, params=bundle.args[0])
    return bundle, stats, time.perf_counter() - t0


def _collectives(bundle: StepBundle, stats: OpStats, sizes: dict) -> dict:
    """The placement rule of the module docstring -> bytes per device by kind."""
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    train = bundle.kind == "train"
    pspecs = bundle.specs[0]
    data_axes = bundle.specs[2 if train else 1][0]  # the batch's axes
    for name, p in bundle.args[0].items():
        spec = pspecs[name]
        shard = _nbytes(p) / _split(spec, sizes)
        on_data = any("data" in _axes(e) for e in spec) and sizes["data"] > 1
        if on_data:
            out["all-gather"] += (2 if train else 1) * shard * sizes["data"]
        if not train:
            continue
        if on_data:
            out["reduce-scatter"] += shard
        elif _split((data_axes,), sizes) > 1:
            out["all-reduce"] += shard
        if sizes.get("pod", 1) > 1:
            out["all-reduce"] += shard
    if sizes["model"] > 1:
        rows = _split((bundle.act_spec[0],), sizes)
        for (name, dim), nbytes in stats.products.items():
            if "model" in _axes(pspecs[name][dim]):
                out["all-reduce"] += nbytes / rows
    return {k: v for k, v in out.items() if v}


def _memory(bundle: StepBundle, stats: OpStats, sizes: dict) -> dict:
    specs, args, b = bundle.specs, bundle.args, bundle.shape.global_batch
    dp = _split((specs[2 if bundle.kind == "train" else 1][0],), sizes)
    argument = sum(_per_device(a, s, sizes) for a, s in zip(args, specs))
    alias = sum(_per_device(args[i], specs[i], sizes) for i in bundle.donate_argnums)
    donated = {id(t) for i in bundle.donate_argnums for t in _tensors(args[i])}
    rest = sum(_nbytes(t) // (dp if t.dim() and t.shape[0] == b else 1)
               for t in _tensors(_results(bundle)) if id(t) not in donated)
    mem = {"argument_bytes": argument, "output_bytes": alias + rest,
           "temp_bytes": stats.temp_peak_bytes // dp, "alias_bytes": alias}
    mem["peak_bytes"] = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
                         - mem["alias_bytes"])
    return mem


def dry_run(cfg, shape, mesh, *, arch: str, shape_name: str, mesh_name: str,
            counted: Optional[tuple] = None, verbose: bool = False) -> tuple[dict, tuple]:
    """The dry-run record of (cfg, shape) on ``mesh`` and its counts
    (OpStats, seconds).  ``counted``: the counts of an earlier run of the
    same (cfg, shape), reused: the global counts do not depend on the
    mesh."""
    sizes = axis_sizes(mesh)
    chips = math.prod(sizes.values())
    bundle, stats, trace_s = count_step(cfg, shape, mesh) if counted is None else (
        build_bundle(cfg, shape, mesh), *counted)
    coll = _collectives(bundle, stats, sizes)
    for kind, nbytes in stats.collective_counts.items():  # issued by the step itself
        coll[kind] = coll.get(kind, 0.0) + nbytes
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "count_method": COUNT_METHOD,
        "flops_total": stats.flops / chips,          # per device
        "bytes_accessed": stats.bytes_accessed / chips,  # per device
        "collective_method": "placement rule",
        "collective_bytes": sum(coll.values()),
        "collective_breakdown": coll,
        "memory": _memory(bundle, stats, sizes),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    record["roofline"] = roofline_report(record, cfg, shape)
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_name} == traced in {trace_s:.1f} s")
        print(json.dumps(record["memory"]))
        print(json.dumps(record["roofline"], indent=2))
    return record, (stats, trace_s)


def _results(bundle: StepBundle):
    """What the step returns, as shapes: train (params, opt state, loss,
    metrics), prefill and decode (logits [B, 1, V], caches)."""
    model, cfg, b = bundle.model, bundle.cfg, bundle.shape.global_batch
    logits = torch.empty((b, 1, cfg.vocab), dtype=model.dtype, device=model.device)
    if bundle.kind == "train":
        scalar = torch.empty((), dtype=torch.float32, device=model.device)
        return (bundle.args[0], bundle.args[1], scalar, {"grad_norm": scalar, "lr": scalar})
    return logits, bundle.args[2]


def run_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
            counts: Optional[dict] = None) -> dict:
    """Count one (arch, shape, mesh) -> the dry-run record.  ``counts``, a
    dict the caller keeps, holds each (arch, shape)'s counts for its other
    mesh."""
    cfg = shape_config(arch, shape_name)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
                "status": "skipped",
                "reason": "no windowed variant in family (configs.supports_shape)"}
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        record, counted = dry_run(
            cfg, INPUT_SHAPES[shape_name], mesh, arch=arch, shape_name=shape_name,
            mesh_name=_mesh_name(multi_pod),
            counted=None if counts is None else counts.get((arch, shape_name)), verbose=verbose)
    if counts is not None:
        counts[(arch, shape_name)] = counted
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    counts: dict = {}
    t0 = time.perf_counter()
    for a, s, mp in combos:
        tag = f"{a}__{s}__{_mesh_name(mp)}"
        out_file = outdir / f"{tag}.json"
        if out_file.exists():
            print(f"skip (cached): {tag}")
            continue
        try:
            rec = run_one(a, s, multi_pod=mp, counts=counts)
        except Exception as e:  # a failure here is a bug in the port: record it, go on
            failures += 1
            rec = {"arch": a, "shape": s, "mesh": _mesh_name(mp),
                   "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"FAILED: {tag}: {e}", file=sys.stderr)
        out_file.write_text(json.dumps(rec, indent=2, default=float))
    print(f"done: {len(combos)} combos, {failures} failures in "
          f"{time.perf_counter() - t0:.1f} s -> {outdir}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
