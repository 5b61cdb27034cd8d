"""The port's architecture registry and patch inputs against the JAX package (CPU).

All ten configs, full and smoke, equal the JAX package's field by field;
the skip table, the per-shape configs and the long-context variant too.
The parameter trees of the eight archs served after qwen3-0.6b and jamba
carry over leaf for leaf (tied embeddings, LayerNorm biases, the
non-parametric norm's placeholder, MoE-only blocks, xLSTM mixers without
an ffn, Whisper's encoder stack and cross-attention).  internvl2-2b's patch embeddings,
from a numpy seed, go through the port's prefill and decode and through
its serving engine, held to the JAX model and engine; the engine's
static patch buffer is rewritten for every job a graph replays.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.serving import ServeConfig, ServingEngine

from test_torch_graphs import stub_graphs  # noqa: F401  (a fixture)
from test_torch_model import (MODEL_CONFIGS, PATCH_CONFIGS, TOL, _assert_caches_equal, _build,
                              _tokens)

SERVED = ("qwen3-14b", "deepseek-7b", "olmo-1b", "internvl2-2b", "phi3.5-moe-42b-a6.6b",
          "dbrx-132b", "whisper-base", "xlstm-350m")


def test_registry_matches_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW
    assert set(configs.INPUT_SHAPES) == set(jconfigs.INPUT_SHAPES)
    for name, shape in configs.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jconfigs.INPUT_SHAPES[name])


@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_jax(arch, kind):
    get, jget = ((configs.get_config, jconfigs.get_config) if kind == "full" else
                 (configs.get_smoke_config, jconfigs.get_smoke_config))
    cfg, jcfg = get(arch), jget(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg.n_layers, cfg.subquadratic, cfg.uses_attention) == \
        (jcfg.n_layers, jcfg.subquadratic, jcfg.uses_attention)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_shape_table_matches_jax(arch):
    for name, shape in jconfigs.INPUT_SHAPES.items():
        assert configs.supports_shape(arch, name) == jconfigs.supports_shape(arch, name)
        assert configs.supports_shape(arch, configs.INPUT_SHAPES[name]) == \
            jconfigs.supports_shape(arch, shape)
        cfg, jcfg = configs.shape_config(arch, name), jconfigs.shape_config(arch, name)
        assert (cfg is None) == (jcfg is None)
        if cfg is not None:
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    variant = configs.long_context_variant(configs.get_config(arch))
    jvariant = jconfigs.long_context_variant(jconfigs.get_config(arch))
    assert dataclasses.asdict(variant) == dataclasses.asdict(jvariant)


@pytest.mark.parametrize("arch", SERVED)
def test_params_carry_over_leaf_for_leaf(arch):
    """Every leaf of the JAX tree lands on one port parameter and back:
    no lm_head where embeddings are tied, a bias beside each LayerNorm
    weight, the non-parametric norm's placeholder ``np``, MoE leaves of
    MoE-only blocks unstacked per layer, no norm2 where a block has no ffn,
    and the encoder's one stack unstacked per encoder layer."""
    pair = MODEL_CONFIGS[f"{arch}-smoke"]()
    jcfg, cfg = pair
    _, params, model = _build(pair, seed=4)
    state = model.state_dict()
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert set(state) == set(flat)
    for key, value in flat.items():
        assert torch.equal(state[key], value), key
    assert ("lm_head.w" in state) == (not cfg.tie_embeddings)
    norm_leaves = {"rms": {"w"}, "ln": {"w", "b"}, "nonparam_ln": {"np"}}[cfg.norm]
    assert {k.rsplit(".", 1)[1] for k in state if k.startswith("final_norm.")} == norm_leaves
    for layer in range(cfg.n_layers):
        r, pos = divmod(layer, len(cfg.pattern))
        stacked = params["layers"][pos]
        norms = ("norm1", "norm2") if cfg.pattern[pos].ffn != "none" else ("norm1",)
        assert (f"layers.{layer}.norm2.{next(iter(norm_leaves))}" in state) == (len(norms) == 2)
        for norm in norms:
            for leaf in norm_leaves:
                np.testing.assert_array_equal(state[f"layers.{layer}.{norm}.{leaf}"].numpy(),
                                              np.asarray(stacked[norm][leaf][r]))
        if cfg.pattern[pos].ffn == "moe":
            for leaf in ("router", "w_gate", "w_up", "w_down"):
                want = np.asarray(stacked["ffn"][leaf][r])
                got = state[f"layers.{layer}.ffn.{leaf}"]
                assert tuple(got.shape) == want.shape
                np.testing.assert_array_equal(got.numpy(), want)
    if cfg.norm == "nonparam_ln":
        assert state["final_norm.np"].shape == ()
    assert any(k.startswith("encoder.") for k in state) == cfg.is_encoder_decoder
    for i in range(cfg.n_enc_layers):
        for key, leaf in (("mixer.wq", ("mixer", "wq")), ("ffn.w_down", ("ffn", "w_down")),
                          ("norm1.b", ("norm1", "b"))):
            np.testing.assert_array_equal(state[f"encoder.layers.{i}.{key}"].numpy(),
                                          np.asarray(params["encoder"]["layers"][leaf[0]][leaf[1]][i]))


def _patches(seed, cfg, batch):
    """Patch embeddings from a numpy seed, at the token embeddings' scale."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PATCH_CONFIGS))
def test_patch_prefill_and_eight_decode_steps_match_jax(name):
    """Patch embeddings prepended to the prompt: prefill logits and the
    caches of P + S positions, then eight decode steps from cache_len
    P + S, against the JAX model given the same embeddings."""
    pair = PATCH_CONFIGS[name]()
    jcfg, cfg = pair
    jm, params, model = _build(pair, seed=6)
    b, s, max_len = 2, 12, 48
    toks = _tokens(10, (b, s), cfg.vocab)
    extra = _patches(11, cfg, b)
    jl, jc, _ = jm.prefill(params, jnp.asarray(toks), jm.init_caches(b, max_len),
                           jnp.asarray(extra))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.as_tensor(toks), model.init_caches(b, max_len),
                               torch.as_tensor(extra))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_equal(jc, tc, cfg)
    assert not bool(tc[0]["kv"].k[:, cfg.n_patches + s:].any())

    cache_len = np.full((b,), cfg.n_patches + s, np.int32)
    for tok in _tokens(12, (8, b, 1), cfg.vocab):
        jl, jc = jm.decode_step(params, jnp.asarray(tok), jc, jnp.asarray(cache_len))
        with torch.inference_mode():
            tl, tc = model.decode_step(torch.as_tensor(tok), tc, torch.as_tensor(cache_len))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cache_len = cache_len + 1
    _assert_caches_equal(jc, tc, cfg)


@pytest.mark.parametrize("name", sorted(PATCH_CONFIGS))
def test_patch_prefill_matches_jax_forward_train(name):
    jm, params, model = _build(PATCH_CONFIGS[name](), seed=7)
    cfg = model.cfg
    b, s = 2, 10
    toks, extra = _tokens(13, (b, s), cfg.vocab), _patches(14, cfg, b)
    hidden, _ = jm.forward_train(params, jnp.asarray(toks), jnp.asarray(extra))
    assert hidden.shape[1] == cfg.n_patches + s
    want = np.asarray(jm._logits(params, hidden[:, -1:]))
    with torch.inference_mode():
        got, _ = model.prefill(torch.as_tensor(toks), model.init_caches(b, 32),
                               torch.as_tensor(extra))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _engines(name, max_context=64, batch=2, seed=3):
    jcfg, cfg = PATCH_CONFIGS[name]()
    jeng = JServingEngine(jcfg, JServeConfig(max_context=max_context, batch=batch), seed=seed)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), cfg)
    eng = ServingEngine(cfg, ServeConfig(max_context=max_context, batch=batch), params=state,
                        device="cpu")
    return jeng, eng


@pytest.mark.parametrize("name", sorted(PATCH_CONFIGS))
def test_patch_generate_matches_jax_engine(name):
    """Greedy tokens of the port's engine on the CPU equal the JAX engine's,
    with patch embeddings given and with the default (zeros)."""
    jeng, eng = _engines(name)
    cfg = eng.cfg
    prompts = _tokens(15, (2, 16), cfg.vocab)
    extra = _patches(16, cfg, 2)
    want, _ = jeng.generate(prompts, max_new_tokens=8, extra_embeds=jnp.asarray(extra))
    got, stats = eng.generate(prompts, 8, extra_embeds=extra)
    np.testing.assert_array_equal(got, want)
    assert stats["tokens"] == 16
    assert eng._static.cache_len.tolist() == [cfg.n_patches + 16 + 8] * 2
    zeros_want, _ = jeng.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(eng.generate(prompts, 8)[0], zeros_want)


@pytest.mark.parametrize("name", sorted(PATCH_CONFIGS))
def test_patch_generate_checks_context_and_shape(name):
    _, cfg = PATCH_CONFIGS[name]()
    eng = ServingEngine(cfg, ServeConfig(max_context=cfg.n_patches + 12, batch=2), device="cpu")
    prompts = _tokens(17, (2, 8), cfg.vocab)
    eng.generate(prompts, 4)  # patches + prompt + new tokens = max_context
    with pytest.raises(ValueError, match="max_context"):
        eng.generate(prompts, 5)
    with pytest.raises(ValueError, match="n_patches"):
        eng.generate(prompts, 4, extra_embeds=np.zeros((2, cfg.n_patches + 1, cfg.d_model)))
    _, plain = MODEL_CONFIGS["qwen3-14b-smoke"]()
    with pytest.raises(ValueError, match="no patch embeddings"):
        ServingEngine(plain, ServeConfig(max_context=32, batch=2), device="cpu").generate(
            prompts, 2, extra_embeds=np.zeros((2, 1, plain.d_model)))


@pytest.mark.parametrize("name", sorted(PATCH_CONFIGS))
def test_graph_replays_read_each_jobs_patches(name, stub_graphs):  # noqa: F811
    """With the steps held as graphs (a stub that replays the captured
    step), two jobs with different patch embeddings each write their own
    into the static buffer the graph reads: each job's tokens equal a fresh
    engine's eager job with its embeddings, and the buffer keeps its
    address."""
    _, cfg = PATCH_CONFIGS[name]()
    prompts = _tokens(18, (2, 10), cfg.vocab)
    extras = [_patches(19, cfg, 2) * 50.0, _patches(20, cfg, 2) * 50.0]
    eng = ServingEngine(cfg, ServeConfig(max_context=48, batch=2), seed=5, device="cpu")
    eng.capture(10)
    buf = eng._static.patches
    ptr = buf.data_ptr()
    outs = []
    for extra in extras + extras[:1]:
        got, _ = eng.generate(prompts, 6, extra_embeds=extra)
        assert eng._static.patches.data_ptr() == ptr
        torch.testing.assert_close(buf, torch.as_tensor(extra).to(buf.dtype), rtol=0, atol=0)
        fresh = ServingEngine(cfg, ServeConfig(max_context=48, batch=2), seed=5, device="cpu")
        want, _ = fresh._generate(prompts, 6, None, (None, 0), eager=True, extra_embeds=extra)
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert len(stub_graphs) == 2
    assert not np.array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
