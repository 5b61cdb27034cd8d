"""AdamW with decoupled weight decay and a cosine learning-rate schedule.

Counterpart of ``repro.train.optimizer``, step for step: the gradients
clipped by their global norm over every leaf, ``step + 1`` before the
learning rate, bias corrections, decay on every leaf, the update in
float32 cast back to the parameter's dtype.  The state holds m and v in
float32 for each of the model's parameters, keyed by name in the JAX
package's leaf order (``convert.jax_leaves``), and the step as an int32
scalar; the update writes the parameters, m and v in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.convert import jax_layout, jax_leaves

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    m: dict  # parameter name -> float32 tensor
    v: dict  # parameter name -> float32 tensor
    step: torch.Tensor  # int32 scalar


def _leaf_names(model) -> list[str]:
    """The model's parameter names in JAX's leaf order (a stacked leaf's
    layers one after another, repeat by repeat)."""
    names = [name for name, _ in model.named_parameters()]
    return [n for leaf in jax_leaves(jax_layout(names, model.cfg))
            for n in (leaf if isinstance(leaf, list) else [leaf])]


def init_opt_state(model) -> OptState:
    params = dict(model.named_parameters())
    names = _leaf_names(model)

    def zeros():
        return {n: torch.zeros(params[n].shape, dtype=torch.float32, device=params[n].device)
                for n in names}

    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=model.embed["w"].device))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine to 0 at
    ``total_steps``; float32, from the step tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, model, state: OptState) -> tuple[OptState, dict]:
    """One step on the gradients in the parameters' ``.grad`` (None reads as
    zeros, as JAX's gradient of an unused leaf) -> (state, {"grad_norm",
    "lr"}), both float32 scalars on the device.  Multi-tensor ops over all
    leaves at once, each the same float32 operation, in the same order, as
    JAX's per-leaf update."""
    params = dict(model.named_parameters())
    ps = [params[n] for n in state.m]
    ms, vs = list(state.m.values()), list(state.v.values())
    grads = [torch.zeros_like(m) if p.grad is None else p.grad.float() for p, m in zip(ps, ms)]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    g = torch._foreach_mul(grads, scale)
    del grads
    torch._foreach_mul_(ms, cfg.b1)  # m = b1 m + (1 - b1) g
    torch._foreach_add_(ms, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(g, g)  # v = b2 v + (1 - b2) g^2
    torch._foreach_mul_(g, 1 - cfg.b2)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_add_(vs, g)
    del g
    den = torch._foreach_div(vs, b2c)  # sqrt(v / b2c) + eps
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(ms, b1c)  # (m / b1c) / den + wd p
    torch._foreach_div_(delta, den)
    del den
    pf = [p.float() for p in ps]
    torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_copy_(ps, torch._foreach_sub(pf, delta))  # cast back to p's dtype
    return OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}
