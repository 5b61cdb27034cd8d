"""Numerical-backend selection for the batched schedulability analyzer.

``repro_torch.core.rta_batch`` evaluates whole frontiers of candidate
allocations with array kernels.  Two implementations exist in the port:

  ``numpy``  (default) — vectorized NumPy; bit-compatible with the scalar
             reference path in ``repro_torch.core.rta`` (sums are accumulated
             in the same order, so R̂ values match exactly).
  ``torch``  — the lockstep fixed point as float64 torch ops on the card
             (``cuda``), in place of the reference's ``jax`` engine; held
             to 1e-9.  Selecting it without a CUDA device raises.
             ``torch:cpu`` names the same engine on the CPU.

The reference's ``jax`` engine is not copied: the port imports no JAX, and
``set_backend("jax")`` raises ``ValueError`` as any unknown name does.
Selection, in precedence order: an explicit ``backend=`` argument to the
batched APIs, :func:`set_backend`, the ``REPRO_RTA_BACKEND`` environment
variable, else ``numpy``.
"""
from __future__ import annotations

import os

__all__ = ["available_backends", "get_backend", "set_backend"]

_VALID = ("numpy", "torch", "torch:cpu")
_backend: str | None = None


def available_backends() -> tuple[str, ...]:
    import torch

    return _VALID if torch.cuda.is_available() else ("numpy", "torch:cpu")


def set_backend(name: str) -> str:
    """Select the analysis backend ("numpy", "torch" or "torch:cpu");
    returns the name."""
    global _backend
    if name not in _VALID:
        raise ValueError(f"unknown RTA backend {name!r}; choose from {_VALID}")
    if name == "torch":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the torch backend runs on the card and no CUDA device "
                               "is present; name the CPU with 'torch:cpu'")
    _backend = name
    return name


def get_backend() -> str:
    """The currently selected backend name (resolving env default once)."""
    global _backend
    if _backend is None:
        set_backend(os.environ.get("REPRO_RTA_BACKEND", "numpy"))
    return _backend
