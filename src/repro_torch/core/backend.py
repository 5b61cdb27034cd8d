"""Numerical-backend selection for the batched schedulability analyzer.

``repro_torch.core.rta_batch`` evaluates whole frontiers of candidate
allocations with array kernels.  One implementation exists in the port:

  ``numpy``  (default) — vectorized NumPy; bit-compatible with the scalar
             reference path in ``repro_torch.core.rta`` (sums are accumulated
             in the same order, so R̂ values match exactly).

The reference's ``jax`` engine is not copied: the port imports no JAX, and
``set_backend("jax")`` raises ``ValueError`` as any unknown name does.
Selection, in precedence order: an explicit ``backend=`` argument to the
batched APIs, :func:`set_backend`, the ``REPRO_RTA_BACKEND`` environment
variable, else ``numpy``.
"""
from __future__ import annotations

import os

__all__ = ["available_backends", "get_backend", "set_backend"]

_VALID = ("numpy",)
_backend: str | None = None


def available_backends() -> tuple[str, ...]:
    return _VALID


def set_backend(name: str) -> str:
    """Select the analysis backend ("numpy"); returns the name."""
    global _backend
    if name not in _VALID:
        raise ValueError(f"unknown RTA backend {name!r}; choose from {_VALID}")
    _backend = name
    return name


def get_backend() -> str:
    """The currently selected backend name (resolving env default once)."""
    global _backend
    if _backend is None:
        set_backend(os.environ.get("REPRO_RTA_BACKEND", "numpy"))
    return _backend
