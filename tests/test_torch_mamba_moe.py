"""The port's Mamba mixer and MoE ffn against the JAX package on the CPU.

Parameters come from the JAX init functions (float32), inputs are made
with numpy from a seed and fed to both packages; outputs, states and the
MoE aux loss must match to 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LayerSpec as JLayerSpec
from repro.models import ModelConfig as JModelConfig
from repro.models import mamba as jmb
from repro.models.blocks import _mamba_prefill as jax_mamba_prefill
from repro.models.moe import init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs import get_smoke_config
from repro_torch.models import LayerSpec, ModelConfig
from repro_torch.models.mamba import Mamba, MambaState, mamba_decode, mamba_prefill
from repro_torch.models.moe import MoE, _capacity, _top_k, moe_ffn

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return module


def _mamba_pair(seed=0):
    jcfg, tcfg = jax_smoke_config("jamba-v0.1-52b"), get_smoke_config("jamba-v0.1-52b")
    params = jmb.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, params, _load(Mamba(tcfg, torch.float32, "cpu"), params)


def _assert_state(got: MambaState, want):
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(want.conv), **TOL)
    np.testing.assert_allclose(got.ssm.numpy(), np.asarray(want.ssm), **TOL)


@pytest.mark.parametrize("s", [20, 256])  # one chunk; two 128-step chunks
def test_mamba_prefill_and_eight_decode_steps_match_jax(s):
    jcfg, tcfg, params, mixer = _mamba_pair()
    b = 2
    x = _rand(1, (b, s, jcfg.d_model), 0.5)
    want, jstate = jax_mamba_prefill(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, state = mamba_prefill(mixer, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(state, jstate)

    for i, xt in enumerate(_rand(2, (8, b, 1, jcfg.d_model), 0.5)):
        want, jstate = jmb.mamba_decode(params, jcfg, jnp.asarray(xt), jstate)
        with torch.inference_mode():
            got, state = mamba_decode(mixer, tcfg, torch.from_numpy(xt), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {i}")
        _assert_state(state, jstate)


def test_mamba_decode_from_the_fresh_state_matches_jax():
    """Decode without a prefill: the conv buffer starts float32."""
    jcfg, tcfg, params, mixer = _mamba_pair(seed=4)
    jstate = jmb.init_mamba_state(jcfg, 2)
    state = MambaState(*(torch.from_numpy(np.array(a)) for a in jstate))
    for xt in _rand(5, (3, 2, 1, jcfg.d_model), 0.5):
        want, jstate = jmb.mamba_decode(params, jcfg, jnp.asarray(xt), jstate)
        with torch.inference_mode():
            got, state = mamba_decode(mixer, tcfg, torch.from_numpy(xt), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_state(state, jstate)


def _moe_pair(e=4, k=2, d=32, f=48, cap_factor=1.25):
    """tests/test_moe.py::cfg_moe in both packages."""
    fields = dict(name="m", arch_type="moe", d_model=d, n_heads=2, n_kv_heads=2, d_ff=f,
                  vocab=64, n_repeats=1, n_experts=e, top_k=k,
                  capacity_factor=cap_factor, dtype="float32")
    return (JModelConfig(pattern=(JLayerSpec("attn", "moe"),), **fields),
            ModelConfig(pattern=(LayerSpec("attn", "moe"),), **fields))


def _moe_case(jcfg, tcfg, x, seed=0, zero_router=False):
    params = init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if zero_router:
        params = dict(params, router=jnp.zeros_like(params["router"]))
    want, want_aux = jax_moe_ffn(params, jcfg, jnp.asarray(x))
    ffn = _load(MoE(tcfg, torch.float32, "cpu"), params)
    with torch.inference_mode():
        got, aux = moe_ffn(ffn, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)
    return params


def _expert_loads(params, x, k):
    """Tokens routed to each (row, expert), from JAX's own routing."""
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    e = params["router"].shape[1]
    return np.asarray(jax.nn.one_hot(idx, e).sum(axis=(1, 2)))  # [B, E]


def test_moe_with_capacity_drops_matches_jax():
    jcfg, tcfg = _moe_pair(cap_factor=0.5)
    x = _rand(1, (2, 16, 32), 0.5)
    params = _moe_case(jcfg, tcfg, x)
    cap = _capacity(16, 4, 2, 0.5)
    assert (_expert_loads(params, x, 2) > cap).any(), "the case must drop tokens"


def test_moe_without_drops_matches_jax():
    jcfg, tcfg = _moe_pair(cap_factor=8.0)
    _moe_case(jcfg, tcfg, _rand(2, (2, 16, 32), 0.5))


def test_moe_longer_than_one_routing_group_matches_jax():
    """One row of 8192 tokens: two 4096-token routing groups."""
    jcfg, tcfg = _moe_pair(e=8, d=16, f=32)
    _moe_case(jcfg, tcfg, _rand(3, (1, 8192, 16)), seed=1)


def test_moe_tied_router_picks_the_experts_jax_picks():
    """A zero router ties every expert: jax.lax.top_k takes the lowest
    indices, and so must the port."""
    jcfg, tcfg = _moe_pair(e=4, k=2)
    x = _rand(4, (2, 16, 32), 0.5)
    params = _moe_case(jcfg, tcfg, x, zero_router=True)
    probs = torch.softmax(torch.zeros(2, 16, 4), dim=-1)
    _, idx = _top_k(probs, 2)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.zeros((2, 16, 4)), axis=-1), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == [0, 1]).all()
    assert (_expert_loads(params, x, 2)[:, 2:] == 0).all()


@pytest.mark.parametrize("n_tokens,n_experts,top_k,factor,want",
                         [(16, 4, 2, 0.5, 8), (256, 16, 2, 1.25, 40), (1, 16, 2, 1.25, 8),
                          (4096, 8, 2, 1.25, 1280), (100, 3, 1, 1.0, 40)])
def test_capacity_rounds_up_to_eight(n_tokens, n_experts, top_k, factor, want):
    from repro.models.moe import _capacity as jax_capacity

    assert _capacity(n_tokens, n_experts, top_k, factor) == want
    assert jax_capacity(n_tokens, n_experts, top_k, factor) == want
