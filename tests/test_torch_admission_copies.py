"""The port's copies of the framework-free modules against the
reference modules they were copied from.

Each copy must be the reference file with ``repro.`` read as
``repro_torch.``: the same syntax tree once docstrings are dropped and the
differences listed in ``ALLOWED`` are cut from both sides.  A copy that
drifts from the oracle fails here by name.
"""
from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

COPIES = [
    "obs/metrics.py",
    "core/workload.py",
    "core/rta.py",
    "core/federated.py",
    "core/backend.py",
    "core/rta_batch.py",
    "sched/capacity.py",
    "sched/trace.py",
    "sched/journal.py",
    "sched/certify.py",
    "sched/controller.py",
    "sched/federation.py",
    "sched/recovery.py",
    "runtime/admission.py",
    "core/generator.py",
    "runtime/engine.py",
    "runtime/simulator.py",
    "runtime/record_golden.py",
    "obs/monitor.py",
    "obs/report.py",
    "runtime/executor.py",
    "core/baselines.py",
    "sched/fleet.py",
    "sched/daemon.py",
    "data/pipeline.py",
]

# module -> {"reference": names cut from the reference, "port": names cut
# from the copy}.  A name is a top-level function, class or assignment
# target; "set_backend/jax" is the ``if name == "jax":`` branch inside
# ``set_backend`` (and "set_backend/torch" the ``if name == "torch":`` one).
ALLOWED = {
    # The port names no JAX backend: "numpy", "torch" (the card) and
    # "torch:cpu" are valid; available_backends() lists "torch" only where
    # a CUDA device is, and set_backend("torch") raises without one.
    "core/backend.py": {
        "reference": {"_VALID", "_jax_available", "available_backends", "set_backend/jax"},
        "port": {"_VALID", "available_backends", "set_backend/torch"},
    },
    # The JAX engine is cut and the torch engine stands in its place; the
    # engine table builds the numpy and torch engines.
    "core/rta_batch.py": {
        "reference": {"_JaxEngine", "_engine"},
        "port": {"_TorchEngine", "_engine"},
    },
}


def _rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _is_docstring(node: ast.stmt) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str))


def _is_branch(node: ast.stmt, value: str) -> bool:
    """``node`` is an ``if name == value:`` branch."""
    return (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
            and any(isinstance(c, ast.Constant) and c.value == value
                    for c in node.test.comparators))


def _top_name(node: ast.stmt):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        return names[0] if len(names) == 1 else None
    return None


def _normalised(text: str, cut: set) -> str:
    tree = ast.parse(text)
    tree.body = [n for n in tree.body if _top_name(n) not in cut]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body and _is_docstring(body[0]):
            body.pop(0)
        if isinstance(node, ast.FunctionDef):
            for branch in ("jax", "torch"):
                if f"{node.name}/{branch}" in cut:
                    body[:] = [n for n in body if not _is_branch(n, branch)]
        if not body:
            body.append(ast.Pass())
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_reference(module):
    ref = _rewrite((REPO / "src" / "repro" / module).read_text())
    port = (REPO / "src" / "repro_torch" / module).read_text()
    allowed = ALLOWED.get(module, {})
    assert _normalised(port, allowed.get("port", set())) == \
        _normalised(ref, allowed.get("reference", set())), \
        f"src/repro_torch/{module} drifted from src/repro/{module}"


@pytest.mark.parametrize("module", sorted(ALLOWED))
def test_allowed_differences_are_really_cut(module):
    """Every name listed as an allowed difference exists where it is cut,
    so the list cannot hide a stale entry."""
    for side, pkg in (("reference", "repro"), ("port", "repro_torch")):
        tree = ast.parse((REPO / "src" / pkg / module).read_text())
        names = {_top_name(n) for n in tree.body}
        for name in ALLOWED[module][side]:
            assert name.split("/")[0] in names, (side, module, name)


@pytest.mark.parametrize("package", ["obs", "core", "sched", "runtime", "data"])
def test_port_package_exports_only_reference_names(package):
    port = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    extra = set(port.__all__) - set(ref.__all__)
    assert not extra, f"repro_torch.{package} exports names the reference does not: {extra}"
    for name in port.__all__:
        assert getattr(port, name) is not None
