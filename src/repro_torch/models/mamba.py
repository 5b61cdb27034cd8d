"""Mamba (selective SSM) mixer: chunked prefill scan and O(1)-state decode.

Counterpart of ``repro.models.mamba``.  Prefill walks 128-step time chunks
as the JAX package does; each chunk's discretized ``abar``/``bx`` go to
``kernels.ops.mamba_scan`` (the hand selective-scan kernel on the card)
with the state carried from the chunk before, so at most one chunk's
``[B, chunk, d_inner, d_state]`` exists at a time.  Decode updates a
``[B, d_inner, d_state]`` SSM state and a rolling ``[B, d_conv-1,
d_inner]`` conv buffer in plain PyTorch, as in JAX, but in place: the new
values are written into the state's own tensors, so a captured decode
step reads and writes the same addresses at every replay.  Training
(``mamba_train``) reaches no kernel, as JAX's does not: each chunk's scan is
JAX's associative scan in plain PyTorch, which autograd differentiates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from .layers import _weight, dense, init_dense

__all__ = ["MambaState", "Mamba", "init_mamba_state", "ssm_scan_chunked",
           "mamba_train", "mamba_prefill", "mamba_decode"]


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, d_inner] trailing inputs
    ssm: torch.Tensor   # [B, d_inner, d_state] float32


class Mamba(nn.Module):
    """in_proj [d, 2*di], conv_w [dc, di], conv_b [di], x_proj [di, 2*ds+1],
    out_proj [di, d] in the model dtype; dt_bias [di], dt_proj [1, di],
    a_log [di, ds], d_skip [di] in float32 (JAX ``init_mamba``)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        f32 = torch.float32
        self.in_proj = _weight((d, 2 * di), dtype, device)
        self.conv_w = _weight((dc, di), dtype, device)
        self.conv_b = _weight((di,), dtype, device)
        self.x_proj = _weight((di, 2 * ds + 1), dtype, device)
        self.dt_bias = _weight((di,), f32, device)
        self.dt_proj = _weight((1, di), f32, device)
        self.a_log = _weight((di, ds), f32, device)
        self.d_skip = _weight((di,), f32, device)
        self.out_proj = _weight((di, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        """The JAX package's scales; S4D-real A = -(1..ds)."""
        dc, ds = self.conv_w.shape[0], self.a_log.shape[1]
        init_dense(self.in_proj, gen)
        init_dense(self.conv_w, gen, dc ** -0.5)
        self.conv_b.zero_()
        init_dense(self.x_proj, gen)
        self.dt_bias.zero_()
        init_dense(self.dt_proj, gen)
        self.a_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32)))
        self.d_skip.fill_(1.0)
        init_dense(self.out_proj, gen)


def _ssm_params(p: Mamba, xc):
    """Per-step SSM parameters from the post-conv activation xc [..., di]:
    abar, bx [..., di, ds] float32 and c_t [..., ds] in xc's dtype."""
    ds = p.a_log.shape[1]
    ptype = torch.promote_types(xc.dtype, p.x_proj.dtype)  # JAX's promotion
    proj = dense(xc.to(ptype), p.x_proj.to(ptype))  # [..., 2*ds+1]
    b_t = proj[..., :ds]
    c_t = proj[..., ds:2 * ds]
    dt_raw = proj[..., 2 * ds:]  # [..., 1]
    dt = F.softplus(dt_raw.float() @ p.dt_proj + p.dt_bias)  # [..., di]
    a = -torch.exp(p.a_log)  # [di, ds]
    abar = torch.exp(dt[..., None] * a)
    bx = (dt * xc.float())[..., None] * b_t[..., None, :].float()
    return abar, bx, c_t


def ssm_scan_chunked(p: Mamba, xc, chunk: int = 128):
    """xc [B, S, di] post-conv activations -> (y [B, S, di] f32, h_final).

    One chunk's abar/bx at a time, the state carried between chunks; a
    sequence that ``chunk`` does not divide is one chunk, as in JAX."""
    s = xc.shape[1]
    if s % chunk != 0:
        chunk = s
    h = None
    ys = []
    for start in range(0, s, chunk):
        abar, bx, c_t = _ssm_params(p, xc[:, start:start + chunk])
        y, h = ops.mamba_scan(abar, bx, c_t, h)
        ys.append(y)
        del abar, bx  # keep the peak at one chunk
    y = torch.cat(ys, dim=1)
    return y + xc.float() * p.d_skip, h


def _associative_scan(abar, bx):
    """Inclusive scan along dim 1 of h_t = abar_t * h_{t-1} + bx_t from a
    zero state (``jax.lax.associative_scan`` of JAX's ``combine``), by
    doubling strides -> (a_cum, h) with a_cum the running product of abar."""
    step = 1
    while step < abar.shape[1]:
        a_now = abar[:, step:]
        bx = torch.cat([bx[:, :step], bx[:, :-step] * a_now + bx[:, step:]], dim=1)
        abar = torch.cat([abar[:, :step], abar[:, :-step] * a_now], dim=1)
        step *= 2
    return abar, bx


def _ssm_scan_train(p: Mamba, xc, chunk: int = 128):
    """JAX ``ssm_scan_chunked`` in plain PyTorch: per chunk the associative
    scan, then the carried state h added through the running product ->
    (y [B, S, di] f32, h_final)."""
    b, s, di = xc.shape
    if s % chunk != 0:
        chunk = s
    h = xc.new_zeros((b, di, p.a_log.shape[1]), dtype=torch.float32)
    ys = []
    for start in range(0, s, chunk):
        abar, bx, c_t = _ssm_params(p, xc[:, start:start + chunk])
        a_cum, h_inner = _associative_scan(abar, bx)
        h_all = h_inner + a_cum * h[:, None]  # [B, chunk, di, ds]
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, c_t.float()))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)
    return y + xc.float() * p.d_skip, h


def _causal_conv(p: Mamba, x):
    """Depthwise causal conv over time, x [B, S, di]; JAX's summation order."""
    dc, s = p.conv_w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(pad[:, i:i + s, :] * p.conv_w[i] for i in range(dc))
    return F.silu(out + p.conv_b)


def mamba_prefill(p: Mamba, cfg, x):
    """Mamba over the prompt x [B, S, D] -> (out [B, S, D], final state);
    JAX ``blocks._mamba_prefill``."""
    di = cfg.d_inner
    xi = dense(x, p.in_proj)
    xz, z = xi[..., :di], xi[..., di:]
    xc = _causal_conv(p, xz)
    y, h_final = ssm_scan_chunked(p, xc)
    out = dense(y.to(x.dtype) * F.silu(z), p.out_proj)
    conv_tail = xz[:, -(cfg.mamba_d_conv - 1):, :].contiguous()
    return out, MambaState(conv=conv_tail, ssm=h_final)


def mamba_train(p: Mamba, cfg, x):
    """x [B, S, D] -> [B, S, D] for training: no state, no kernel (call
    inside ``layers.plain_products``); JAX ``mamba_train``."""
    di = cfg.d_inner
    xi = dense(x, p.in_proj)
    xz, z = xi[..., :di], xi[..., di:]
    y, _ = _ssm_scan_train(p, _causal_conv(p, xz))
    return dense(y.to(x.dtype) * F.silu(z), p.out_proj)


def init_mamba_state(cfg, batch: int, device, dtype=torch.float32) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state), dtype=torch.float32,
                        device=device),
    )


def mamba_decode(p: Mamba, cfg, x, state: MambaState):
    """One-token step, x [B, 1, D] -> ([B, 1, D], state): the new conv
    buffer and SSM state are copied into ``state``'s tensors."""
    di = cfg.d_inner
    xi = dense(x[:, 0], p.in_proj)
    xz, z = xi[..., :di], xi[..., di:]  # [B, di]

    # rolling conv buffer, in the buffer's dtype (JAX promotes the product)
    window = torch.cat([state.conv, xz[:, None].to(state.conv.dtype)], dim=1)
    ptype = torch.promote_types(window.dtype, p.conv_w.dtype)
    xc = F.silu(torch.einsum("bcd,cd->bd", window.to(ptype), p.conv_w.to(ptype)) + p.conv_b)
    state.conv.copy_(window[:, 1:])

    abar, bx, c_t = _ssm_params(p, xc)  # [B, di, ds]
    h = state.ssm * abar + bx
    state.ssm.copy_(h)
    y = torch.einsum("bds,bs->bd", h, c_t.float())
    y = y + xc.float() * p.d_skip
    y = y.to(x.dtype) * F.silu(z)
    out = dense(y, p.out_proj)[:, None]
    return out, state
