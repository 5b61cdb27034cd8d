"""Shared neural layers: norms, rotary embeddings, SwiGLU MLP, embeddings.

Counterpart of ``repro.models.layers``.  Weights keep the JAX layout
``[d_in, d_out]`` and are applied as ``x @ w`` through
``kernels.ops.pinned_matmul``, or inside :func:`plain_products` (the
training path) through ``torch.matmul``; init functions fill tensors from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
from torch import nn

from repro_torch.kernels import ops

__all__ = [
    "rms_norm",
    "layer_norm",
    "Norm",
    "init_norm",
    "apply_norm",
    "rotary_cos_sin",
    "apply_rotary",
    "init_dense",
    "dense",
    "plain_products",
    "MLP",
    "mlp",
    "init_embedding",
]


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_dense(w: torch.Tensor, gen: torch.Generator,
               scale: Optional[float] = None) -> None:
    """Fill a [d_in, d_out] weight with normal(0, 1) * scale (d_in**-0.5)."""
    scale = scale if scale is not None else w.shape[0] ** -0.5
    noise = torch.randn(w.shape, generator=gen, device=gen.device)
    w.copy_(noise * scale)


_PLAIN = contextvars.ContextVar("plain_products", default=False)


@contextlib.contextmanager
def plain_products() -> Iterator[None]:
    """Inside the block, :func:`dense` is ``x @ w`` by ``torch.matmul``:
    the training path's products, which autograd differentiates, as the JAX
    package's ``x @ w`` outside any Pallas kernel.  The hand kernels have no
    backward."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def dense(x: torch.Tensor, w: torch.Tensor):
    """x [..., d_in] @ w [d_in, d_out] through the pinned matmul, on the SMs
    of the enclosing ``ops.on_sms`` (all SMs outside one); ``x @ w`` inside
    :func:`plain_products`."""
    if _PLAIN.get():
        return x @ w
    lead = x.shape[:-1]
    n_bands, first_sm = ops.sm_range()
    y = ops.pinned_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                          n_bands=n_bands, first_sm=first_sm)
    return y.reshape(*lead, w.shape[1])


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


class Norm(nn.Module):
    """kind: rms | ln | nonparam_ln (OLMo's non-parametric LayerNorm).

    Holds ``w`` (and ``b`` for ln), or the JAX placeholder leaf ``np``."""

    def __init__(self, kind: str, d: int, dtype, device):
        super().__init__()
        if kind not in ("rms", "ln", "nonparam_ln"):
            raise ValueError(f"unknown norm kind {kind}")
        self.kind = kind
        if kind == "nonparam_ln":
            self.np = _weight((), dtype, device)
        else:
            self.w = _weight((d,), dtype, device)
        if kind == "ln":
            self.b = _weight((d,), dtype, device)


def init_norm(norm: Norm) -> None:
    """Ones for weights, zeros for bias and placeholder (repro's init_norm)."""
    for name, p in norm.named_parameters():
        p.fill_(1.0 if name == "w" else 0.0)


def apply_norm(params: Norm, x, kind: str):
    if kind == "rms":
        return rms_norm(x, params.w)
    if kind == "ln":
        return layer_norm(x, params.w, params.b)
    return layer_norm(x, None, None)  # non-parametric (arXiv:2402.00838)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: int tensor [...]; returns float32 cos/sin [..., head_dim/2]."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exps)  # a Python base: no host-to-device copy
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """Half-split rotary; x: [..., n_heads, head_dim], cos/sin broadcast
    over the head axis.  Computed in float32, cast back to x.dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


class MLP(nn.Module):
    """SwiGLU weights: w_gate, w_up [d_model, d_ff]; w_down [d_ff, d_model]."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = _weight((d_model, d_ff), dtype, device)
        self.w_up = _weight((d_model, d_ff), dtype, device)
        self.w_down = _weight((d_ff, d_model), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            init_dense(w, gen)


def mlp(params: MLP, x):
    """SwiGLU feed-forward."""
    gate = torch.nn.functional.silu(dense(x, params.w_gate))
    up = dense(x, params.w_up)
    return dense(gate * up, params.w_down)


def init_embedding(w: torch.Tensor, gen: torch.Generator) -> None:
    """Fill a [vocab, d_model] table with normal(0, 1) * 0.02."""
    w.copy_(torch.randn(w.shape, generator=gen, device=gen.device) * 0.02)
