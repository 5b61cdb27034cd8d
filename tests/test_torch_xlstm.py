"""The port's xLSTM mixers (repro_torch.models.xlstm) against the JAX
package's on the CPU, in float32.

Parameters come from the JAX ``init_mlstm``/``init_slstm``, inputs and
states from numpy seeds; each function's output and states must match its
JAX twin to 2e-4: one mLSTM step from a random state, both prefill scans
(output and final state), and eight decode steps of each mixer from the
state its scan left.  The serving engine's reset zeroes the xLSTM states.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxl
from repro_torch.configs import get_smoke_config
from repro_torch.models import xlstm as xl
from repro_torch.serving import ServeConfig, ServingEngine

from test_torch_model import TOL, _tokens

CFG = get_smoke_config("xlstm-350m")  # d_model 256, 4 heads, di 512, hd 128
B, S = 2, 12


def _mixer(kind, seed):
    """(JAX params, the port module holding them) of an mLSTM or sLSTM."""
    init, module = {"mlstm": (jxl.init_mlstm, xl.MLstm),
                    "slstm": (jxl.init_slstm, xl.SLstm)}[kind]
    params = init(jax.random.PRNGKey(seed), CFG, jnp.float32)
    mixer = module(CFG, torch.float32, "cpu")
    mixer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return params, mixer


def _x(seed, s=S):
    return np.random.default_rng(seed).standard_normal((B, s, CFG.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _states_close(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


def test_mlstm_step_matches_jax():
    """One step from a random state, the stabiliser's branches both taken
    (input gates above and below f + m)."""
    rng = np.random.default_rng(0)
    h, hd = CFG.n_heads, 16
    c = rng.standard_normal((B, h, hd, hd)).astype(np.float32)
    n = rng.standard_normal((B, h, hd)).astype(np.float32)
    m = rng.standard_normal((B, h)).astype(np.float32)
    q, k, v = (rng.standard_normal((B, h, hd)).astype(np.float32) for _ in range(3))
    i_t = (rng.standard_normal((B, h)) * 3).astype(np.float32)
    f_t = np.log(1 / (1 + np.exp(-rng.standard_normal((B, h))))).astype(np.float32)
    (jc, jn, jm), jy = jxl._mlstm_step((c, n, m), (q, k, v, i_t, f_t), hd)
    (tc, tn, tm), ty = xl._mlstm_step(
        tuple(torch.from_numpy(a) for a in (c, n, m)),
        tuple(torch.from_numpy(a) for a in (q, k, v, i_t, f_t)))
    assert bool(((f_t + m) > i_t).any()) and bool(((f_t + m) < i_t).any())
    for got, want in ((tc, jc), (tn, jn), (tm, jm), (ty, jy)):
        _close(got, want)


@pytest.mark.parametrize("s", [S, 130])
def test_mlstm_scan_matches_jax(s):
    """Output and final state; 130 steps is one JAX chunk (130 % 128 != 0),
    S = 12 too: the port's step loop has no chunks."""
    params, mixer = _mixer("mlstm", 1)
    x = _x(2, s)
    jy, jstate = jxl._mlstm_scan(params, CFG, jnp.asarray(x))
    with torch.inference_mode():
        ty, tstate = xl._mlstm_scan(mixer, CFG, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tstate, jstate)


def test_mlstm_scan_chunks_like_jax():
    """256 steps: JAX walks two 128-step chunks with the state carried."""
    params, mixer = _mixer("mlstm", 3)
    x = _x(4, 256)
    jy, jstate = jxl._mlstm_scan(params, CFG, jnp.asarray(x))
    with torch.inference_mode():
        ty, tstate = xl._mlstm_scan(mixer, CFG, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tstate, jstate)


@pytest.mark.parametrize("s", [S, 256])
def test_slstm_scan_matches_jax(s):
    params, mixer = _mixer("slstm", 5)
    x = _x(6, s)
    jy, jstate = jxl._slstm_scan(params, CFG, jnp.asarray(x))
    with torch.inference_mode():
        ty, tstate = xl._slstm_scan(mixer, CFG, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tstate, jstate)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax(kind):
    """Eight one-token steps from the state the scan left, each output and
    the state after it; the port writes the state into the tensors it was
    given."""
    params, mixer = _mixer(kind, 7)
    jscan, jdecode = {"mlstm": (jxl._mlstm_scan, jxl.mlstm_decode),
                      "slstm": (jxl._slstm_scan, jxl.slstm_decode)}[kind]
    tscan, tdecode = {"mlstm": (xl._mlstm_scan, xl.mlstm_decode),
                      "slstm": (xl._slstm_scan, xl.slstm_decode)}[kind]
    x = _x(8)
    _, jstate = jscan(params, CFG, jnp.asarray(x))
    with torch.inference_mode():
        _, tstate = tscan(mixer, CFG, torch.from_numpy(x))
    ptrs = [t.data_ptr() for t in tstate]
    for i in range(8):
        tok = _x(20 + i, 1)
        jy, jstate = jdecode(params, CFG, jnp.asarray(tok), jstate)
        with torch.inference_mode():
            ty, out_state = tdecode(mixer, CFG, torch.from_numpy(tok), tstate)
        assert out_state is tstate and ty.shape == (B, 1, CFG.d_model)
        _close(ty, jy)
        _states_close(tstate, jstate)
    assert [t.data_ptr() for t in tstate] == ptrs


def test_zero_state_decode_matches_jax():
    """Decode from the zero state (``init_*_state``), as after a reset."""
    for kind, jinit, tinit, jdecode, tdecode in (
            ("mlstm", jxl.init_mlstm_state, xl.init_mlstm_state, jxl.mlstm_decode,
             xl.mlstm_decode),
            ("slstm", jxl.init_slstm_state, xl.init_slstm_state, jxl.slstm_decode,
             xl.slstm_decode)):
        params, mixer = _mixer(kind, 9)
        tok = _x(10, 1)
        jy, jstate = jdecode(params, CFG, jnp.asarray(tok), jinit(CFG, B))
        with torch.inference_mode():
            ty, tstate = tdecode(mixer, CFG, torch.from_numpy(tok), tinit(CFG, B, "cpu"))
        _close(ty, jy)
        _states_close(tstate, jstate)


def test_reset_zeroes_the_xlstm_states():
    eng = ServingEngine(CFG, ServeConfig(max_context=32, batch=2), seed=1, device="cpu")
    eng.generate(_tokens(3, (2, 12), CFG.vocab), 4)
    st = eng._static
    states = [t for c in st.caches for t in c["xl"]]
    assert len(states) == 3 + 4 and all(bool(t.abs().sum() > 0) for t in states)
    eng.model.reset_caches(st.caches, st.cache_len)
    assert all(not bool(t.any()) for t in states) and not bool(st.cache_len.any())
