"""xLSTM mixers (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

Counterpart of ``repro.models.xlstm``.  mLSTM keeps a per-head matrix
memory C [hd, hd] with exponential input/forget gates and a max-state
stabiliser; queries read the memory.  sLSTM keeps scalar memories with
exponential gating and recurrent weights.  Every weight product goes
through ``layers.dense`` (the pinned matmul on the card), the float32
gate products included.

Prefill walks the prompt one step at a time in Python, the state carried
from step to step in float32 from zero, as the JAX scan does (its
128-step chunks exist for its backward and change no forward value); a
CUDA graph captures the loop once.  Each sLSTM step takes both its gate
products, ``x_t @ w_gates`` and ``h @ r_gates`` at M = B, as the JAX
step does.  Decode runs one step and copies the new state
into the cache's own tensors, so a captured decode step reads and writes
the same addresses at every replay.  Training (``mlstm_train``,
``slstm_train``) runs the same step loop under autograd, with no cache.
Both loops are ``roofline.step_loop``s: counted by ``roofline.analyze_step``
they run three steps, the middle one weighted by ``s - 2`` (its output
stands for every middle step's); everywhere else they run every step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import roofline

from .layers import _weight, dense, init_dense, rms_norm

__all__ = ["MLstmState", "SLstmState", "MLstm", "SLstm", "init_mlstm_state",
           "init_slstm_state", "mlstm_train", "slstm_train", "mlstm_decode", "slstm_decode"]


class MLstmState(NamedTuple):
    c: torch.Tensor  # [B, H, hd, hd] matrix memory, float32
    n: torch.Tensor  # [B, H, hd]     normaliser, float32
    m: torch.Tensor  # [B, H]         gate stabiliser (log space), float32


class SLstmState(NamedTuple):
    c: torch.Tensor  # [B, di] cell
    n: torch.Tensor  # [B, di] normaliser
    m: torch.Tensor  # [B, di] stabiliser
    h: torch.Tensor  # [B, di] hidden (recurrent input)


def _dims(cfg) -> tuple[int, int, int]:
    """(di, H, hd) of the mixers: di = xlstm_proj_factor * d_model."""
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


# --------------------------------------------------------------------- mLSTM


class MLstm(nn.Module):
    """up_proj [d, 2*di] (x and gate z), wq/wk/wv [di, di], out_norm [di],
    down_proj [di, d] in the model dtype; w_if [di, 2*H] and b_if [2*H]
    (input and forget gates) in float32 (JAX ``init_mlstm``)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, (di, h, _) = cfg.d_model, _dims(cfg)
        f32 = torch.float32
        self.up_proj = _weight((d, 2 * di), dtype, device)
        self.wq = _weight((di, di), dtype, device)
        self.wk = _weight((di, di), dtype, device)
        self.wv = _weight((di, di), dtype, device)
        self.w_if = _weight((di, 2 * h), f32, device)
        self.b_if = _weight((2 * h,), f32, device)
        self.out_norm = _weight((di,), dtype, device)
        self.down_proj = _weight((di, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.up_proj, self.wq, self.wk, self.wv, self.w_if, self.down_proj):
            init_dense(w, gen)
        self.b_if.zero_()
        self.out_norm.fill_(1.0)


def _mlstm_qkv(p: MLstm, xz, h: int, hd: int):
    """q, k (scaled by hd**-0.5) and v [B, S, H, hd] in xz's dtype; the
    input gate and the log-sigmoid forget gate [B, S, H] in float32."""
    b, s, _ = xz.shape
    q = dense(xz, p.wq).reshape(b, s, h, hd) * hd ** -0.5
    k = dense(xz, p.wk).reshape(b, s, h, hd) * hd ** -0.5
    v = dense(xz, p.wv).reshape(b, s, h, hd)
    gates = dense(xz.float(), p.w_if) + p.b_if
    i_gate, f_gate = gates[..., :h], gates[..., h:]
    return q, k, v, i_gate, F.logsigmoid(f_gate)


def _mlstm_step(carry, inputs):
    """One time step of JAX ``_mlstm_step``: carry (c, n, m), inputs q_t,
    k_t, v_t [B, H, hd] and i_t, f_t [B, H] -> ((c, n, m_new), y [B, H,
    hd] float32).  The outer product k_t v_t is taken in the inputs' dtype,
    and the denominator's floor exp(-m) reads the old stabiliser, as in JAX."""
    c, n, m = carry
    q_t, k_t, v_t, i_t, f_t = inputs
    m_new = torch.maximum(f_t + m, i_t)
    i_eff = torch.exp(i_t - m_new)
    f_eff = torch.exp(f_t + m - m_new)
    kv = (k_t[..., :, None] * v_t[..., None, :]).float()
    c = f_eff[..., None, None] * c + i_eff[..., None, None] * kv
    n = f_eff[..., None] * n + i_eff[..., None] * k_t.float()
    qf = q_t.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    y = num / torch.maximum(den, torch.exp(-m))[..., None]
    return (c, n, m_new), y


def _mlstm_out(p: MLstm, y, z, dtype):
    """out_norm, the silu(z) gate and down_proj over y [..., di]."""
    y = rms_norm(y.to(dtype), p.out_norm)
    return dense(y * F.silu(z), p.down_proj)


def _mlstm_scan(p: MLstm, cfg, x):
    """mLSTM over x [B, S, D] from a zero state -> (out [B, S, D], final
    MLstmState); JAX ``_mlstm_scan``."""
    b, s, _ = x.shape
    di, h, hd = _dims(cfg)
    up = dense(x, p.up_proj)
    xz, z = up[..., :di], up[..., di:]
    q, k, v, i_gate, f_gate = _mlstm_qkv(p, xz, h, hd)
    carry = init_mlstm_state(cfg, b, x.device)
    ys = []
    with roofline.step_loop(s) as steps:
        for t in steps:
            carry, y = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t], i_gate[:, t],
                                           f_gate[:, t]))
            ys.append(y)
    y = torch.stack(roofline.loop_outputs(ys, s), dim=1).reshape(b, s, di)
    return _mlstm_out(p, y, z, x.dtype), MLstmState(*carry)


def mlstm_train(p: MLstm, cfg, x):
    """x [B, S, D] -> [B, S, D] for training (call inside
    ``layers.plain_products``); JAX ``mlstm_train``."""
    return _mlstm_scan(p, cfg, x)[0]


def init_mlstm_state(cfg, batch: int, device) -> MLstmState:
    _, h, hd = _dims(cfg)
    f32 = torch.float32
    return MLstmState(
        c=torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, h, hd), dtype=f32, device=device),
        m=torch.zeros((batch, h), dtype=f32, device=device),
    )


def mlstm_decode(p: MLstm, cfg, x, state: MLstmState):
    """One-token step, x [B, 1, D] -> ([B, 1, D], state): the new state is
    copied into ``state``'s tensors."""
    b = x.shape[0]
    di, h, hd = _dims(cfg)
    up = dense(x[:, 0], p.up_proj)
    xz, z = up[..., :di], up[..., di:]
    q, k, v, i_gate, f_gate = _mlstm_qkv(p, xz[:, None], h, hd)
    carry, y = _mlstm_step(tuple(state), (q[:, 0], k[:, 0], v[:, 0], i_gate[:, 0], f_gate[:, 0]))
    for buf, value in zip(state, carry):
        buf.copy_(value)
    return _mlstm_out(p, y.reshape(b, di), z, x.dtype)[:, None], state


# --------------------------------------------------------------------- sLSTM


class SLstm(nn.Module):
    """up_proj [d, di] and down_proj [di, d] in the model dtype; w_gates and
    r_gates [di, 4*di], b_gates [4*di] in float32, gates in the order z, i,
    f, o (JAX ``init_slstm``)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, (di, _, _) = cfg.d_model, _dims(cfg)
        f32 = torch.float32
        self.up_proj = _weight((d, di), dtype, device)
        self.w_gates = _weight((di, 4 * di), f32, device)
        self.r_gates = _weight((di, 4 * di), f32, device)
        self.b_gates = _weight((4 * di,), f32, device)
        self.down_proj = _weight((di, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.up_proj, self.w_gates, self.r_gates, self.down_proj):
            init_dense(w, gen)  # r_gates: normal * di**-0.5, as JAX draws it
        self.b_gates.zero_()


def _slstm_step(p: SLstm, carry, x_t):
    """One time step of JAX ``_slstm_step``: carry (c, n, m, h), x_t [B, di]
    the up-projected input -> ((c, n, m_new, h_new), h_new), all float32."""
    c, n, m, h = carry
    di = c.shape[-1]
    pre = dense(x_t.float(), p.w_gates) + dense(h, p.r_gates) + p.b_gates
    z = torch.tanh(pre[..., :di])
    i = pre[..., di:2 * di]
    f = F.logsigmoid(pre[..., 2 * di:3 * di])
    o = torch.sigmoid(pre[..., 3 * di:])
    m_new = torch.maximum(f + m, i)
    i_eff = torch.exp(i - m_new)
    f_eff = torch.exp(f + m - m_new)
    c = f_eff * c + i_eff * z
    n = f_eff * n + i_eff
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def _slstm_scan(p: SLstm, cfg, x):
    """sLSTM over x [B, S, D] from a zero state -> (out [B, S, D], final
    SLstmState); JAX ``_slstm_scan``."""
    b, s, _ = x.shape
    up = dense(x, p.up_proj)
    carry = init_slstm_state(cfg, b, x.device)
    hs = []
    with roofline.step_loop(s) as steps:
        for t in steps:
            carry, h = _slstm_step(p, carry, up[:, t])
            hs.append(h)
    y = torch.stack(roofline.loop_outputs(hs, s), dim=1).to(x.dtype)
    return dense(y, p.down_proj), SLstmState(*carry)


def slstm_train(p: SLstm, cfg, x):
    """x [B, S, D] -> [B, S, D] for training (call inside
    ``layers.plain_products``); JAX ``slstm_train``."""
    return _slstm_scan(p, cfg, x)[0]


def init_slstm_state(cfg, batch: int, device) -> SLstmState:
    di = _dims(cfg)[0]
    return SLstmState(*(torch.zeros((batch, di), dtype=torch.float32, device=device)
                        for _ in range(4)))


def slstm_decode(p: SLstm, cfg, x, state: SLstmState):
    """One-token step, x [B, 1, D] -> ([B, 1, D], state): the new state is
    copied into ``state``'s tensors."""
    up = dense(x[:, 0], p.up_proj)
    carry, h = _slstm_step(p, tuple(state), up)
    for buf, value in zip(state, carry):
        buf.copy_(value)
    return dense(h.to(x.dtype), p.down_proj)[:, None], state
