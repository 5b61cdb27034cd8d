"""Mixture-of-Experts FFN with capacity-based dispatch (GShard style).

Counterpart of ``repro.models.moe``: per-row expert capacity rounded up to
a multiple of 8, 4096-token routing groups, top-k over the softmax of f32
router logits (ties to the lower expert index, as ``jax.lax.top_k``),
token-major slots with overflow dropped, SwiGLU experts batched over
(row, expert), and the Switch load-balance loss.  Dispatch and combine are
index copies and gathers where JAX uses one-hot einsums; each kept
(row, token, choice) fills exactly one slot, so the values are the same.
A dropped choice goes to one spare slot past the buffer, whose output
reads as zero: no index depends on how many choices were kept, so the
device never reports a count to the host and a step can be captured as a
CUDA graph.
The router goes through ``layers.dense`` like every projection; the
expert products are batched ``torch.matmul``s, as JAX leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _weight, dense, init_dense

__all__ = ["MoE", "moe_ffn"]

_GROUP = 4096  # routing-group length (JAX moe_ffn)


class MoE(nn.Module):
    """router [d, E] f32; w_gate, w_up [E, d, f] and w_down [E, f, d] in the
    model dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _weight((d, e), torch.float32, device)
        self.w_gate = _weight((e, d, f), dtype, device)
        self.w_up = _weight((e, d, f), dtype, device)
        self.w_down = _weight((e, f, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        """The JAX package's scales: d ** -0.5, and f ** -0.5 for w_down."""
        d, f = self.w_gate.shape[1:]
        init_dense(self.router, gen)
        init_dense(self.w_gate, gen, d ** -0.5)
        init_dense(self.w_up, gen, d ** -0.5)
        init_dense(self.w_down, gen, f ** -0.5)


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(n_tokens * top_k * factor / n_experts)
    return max(cap - cap % -8, 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (the first
    k of a stable descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: MoE, cfg, x):
    """x [B, S, D] -> (y [B, S, D], aux loss); overflow tokens of a
    (row, expert) are dropped and the residual path carries them."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if s > _GROUP and s % _GROUP == 0:
        y, aux = moe_ffn(p, cfg, x.reshape(b * (s // _GROUP), _GROUP, d))
        return y.reshape(b, s, d), aux

    cap = _capacity(s, e, k, cfg.capacity_factor)
    logits = dense(x.float(), p.router)  # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # [B, S, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot of each (row, token, choice) in its expert's buffer, token-major
    flat_expert = expert_idx.reshape(b, s * k)
    onehot = F.one_hot(flat_expert, e)  # [B, S*k, E]
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)  # [B, S*k]
    keep = pos < cap

    # dispatch: buffer [B, E, C, D], one row of x per kept slot; the dropped
    # choices all write the spare slot b*e*cap, which no expert reads
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    spare = b * e * cap
    slot = torch.where(keep, (rows * e + flat_expert) * cap + pos, spare).reshape(-1)
    token = (torch.arange(s * k, device=x.device) // k)[None].expand(b, s * k)
    src = (rows * s + token).reshape(-1)
    buf = x.new_zeros((spare + 1, d))
    buf[slot] = x.reshape(b * s, d)[src]

    # SwiGLU experts, batched over (row, expert): [E, B*C, D] @ [E, D, F]
    buf = buf[:spare].reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    gate = F.silu(torch.matmul(buf, p.w_gate))
    up = torch.matmul(buf, p.w_up)
    out_buf = torch.matmul(gate * up, p.w_down)  # [E, B*C, D]
    out_buf = out_buf.reshape(e, b, cap, d).transpose(0, 1).reshape(spare, d)

    # combine: each kept choice's expert output times its gate, in f32; the
    # spare slot's output is zero
    picked = torch.cat([out_buf, out_buf.new_zeros((1, d))])[slot].float()
    weights = gate_vals.to(x.dtype).float().reshape(b * s * k, 1)
    y = (picked * weights).reshape(b, s, k, d).sum(2).to(x.dtype)

    # load-balance loss (Switch/GShard)
    me = probs.mean(dim=(0, 1))  # [E]
    ce = onehot.sum(dim=(0, 1)).float() / (b * s * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return y, aux
