"""The port's encoder-decoder path (whisper-base) against the JAX package on
the CPU, in float32.

Parameters are the JAX model's, carried by ``params_from_jax``; frame
embeddings and tokens come from numpy seeds.  ``Model._encode``,
``encode_kv`` and ``cross_attention`` must match their JAX twins to 2e-4,
and the serving engine's greedy tokens the JAX engine's, with frames given
and with its default (zeros).  The engine's static frame buffer takes only
[batch, enc_ctx, d_model], and a replayed graph reads each job's frames.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.serving import ServeConfig, ServingEngine

from test_torch_graphs import stub_graphs  # noqa: F401  (a fixture)
from test_torch_model import CONFIGS, ENC_CONFIGS, TOL, _build, _frames, _tokens

NAME = "whisper-base-smoke"  # d_model 256, 4 heads, 2 + 2 layers, enc_ctx 64


def test_encode_matches_jax():
    jm, params, model = _build(ENC_CONFIGS[NAME](), seed=1)
    frames = _frames(2, model.cfg, 2)
    want = jm._encode(params, jnp.asarray(frames))
    with torch.inference_mode():
        got = model._encode(torch.from_numpy(frames))
    assert got.shape == (2, model.cfg.enc_ctx, model.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_encode_kv_and_cross_attention_match_jax(layer):
    """A decoder layer's cross projections on the encoder's output: K/V,
    then the attention of decoder states to them (no rope, no mask)."""
    jm, params, model = _build(ENC_CONFIGS[NAME](), seed=3)
    cfg = model.cfg
    jcross = jax.tree_util.tree_map(lambda a: a[layer], params["layers"][0]["cross"])
    rng = np.random.default_rng(4)
    enc_out = rng.standard_normal((2, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jkv = jattn.encode_kv(jcross, jm.cfg, jnp.asarray(enc_out))
    jout = jattn.cross_attention(jcross, jm.cfg, jnp.asarray(x), jkv)
    cross = model.layers[layer].cross
    with torch.inference_mode():
        kv = attn.encode_kv(cross, cfg, torch.from_numpy(enc_out))
        out = attn.cross_attention(cross, cfg, torch.from_numpy(x), kv)
    assert kv.k.shape == (2, cfg.enc_ctx, cfg.n_kv_heads, cfg.head_dim)
    for got, want in ((kv.k, jkv.k), (kv.v, jkv.v), (out, jout)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_projections_have_no_qk_norm():
    """A qk-norm config normalises self-attention's q and k, not the cross
    projections' (JAX ``init_attention(..., cross=True)``)."""
    _, cfg = CONFIGS["qwen3-0.6b-smoke"]()
    assert cfg.qk_norm
    jparams = jattn.init_attention(jax.random.PRNGKey(0), cfg, jnp.float32, cross=True)
    cross = attn.Attention(cfg, torch.float32, "cpu", cross=True)
    assert set(dict(cross.named_parameters())) == set(jparams) == {"wq", "wk", "wv", "wo"}
    assert {"q_norm", "k_norm"} <= set(dict(attn.Attention(cfg, torch.float32,
                                                           "cpu").named_parameters()))


def _engines(max_context=48, batch=2, seed=3):
    jcfg, cfg = ENC_CONFIGS[NAME]()
    jeng = JServingEngine(jcfg, JServeConfig(max_context=max_context, batch=batch), seed=seed)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), cfg)
    eng = ServingEngine(cfg, ServeConfig(max_context=max_context, batch=batch), params=state,
                        device="cpu")
    return jeng, eng


def test_generate_matches_jax_engine():
    """Greedy tokens of the port's engine equal the JAX engine's, with frames
    given and with the default (zeros); the decoder's positions are the
    prompt and new tokens only."""
    jeng, eng = _engines()
    cfg = eng.cfg
    prompts = _tokens(5, (2, 16), cfg.vocab)
    frames = _frames(6, cfg, 2)
    want, _ = jeng.generate(prompts, max_new_tokens=8, enc_embeds=jnp.asarray(frames))
    got, stats = eng.generate(prompts, 8, enc_embeds=frames)
    np.testing.assert_array_equal(got, want)
    assert stats["tokens"] == 16 and eng._static.cache_len.tolist() == [16 + 8] * 2
    zeros_want, _ = jeng.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(eng.generate(prompts, 8)[0], zeros_want)
    assert not np.array_equal(want, zeros_want)


def test_generate_checks_the_frames_shape():
    _, eng = _engines()
    cfg = eng.cfg
    prompts = _tokens(7, (2, 8), cfg.vocab)
    with pytest.raises(ValueError, match="enc_ctx"):
        eng.generate(prompts, 2, enc_embeds=np.zeros((2, cfg.enc_ctx + 1, cfg.d_model)))
    with pytest.raises(ValueError, match="enc_ctx"):
        eng.generate(prompts, 2, enc_embeds=np.zeros((2, cfg.enc_ctx, cfg.d_model // 2)))
    _, plain = CONFIGS["qwen3-14b-smoke"]()
    with pytest.raises(ValueError, match="no frame embeddings"):
        ServingEngine(plain, ServeConfig(max_context=32, batch=2), device="cpu").generate(
            prompts, 2, enc_embeds=np.zeros((2, 4, plain.d_model)))


def test_graph_replays_read_each_jobs_frames(stub_graphs):  # noqa: F811
    """With the steps held as graphs (a stub that replays the captured
    step), two jobs with different frames each write theirs into the static
    buffer the graph reads: each job's tokens equal a fresh engine's eager
    job with its frames, and the buffer keeps its address."""
    _, cfg = ENC_CONFIGS[NAME]()
    prompts = _tokens(8, (2, 10), cfg.vocab)
    frames = [_frames(9, cfg, 2) * 4.0, _frames(10, cfg, 2) * 4.0]
    eng = ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=5, device="cpu")
    eng.capture(10)
    buf = eng._static.frames
    ptr = buf.data_ptr()
    outs = []
    for f in frames + frames[:1]:
        got, _ = eng.generate(prompts, 6, enc_embeds=f)
        assert eng._static.frames.data_ptr() == ptr
        torch.testing.assert_close(buf, torch.as_tensor(f), rtol=0, atol=0)
        fresh = ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=5, device="cpu")
        want, _ = fresh._generate(prompts, 6, None, (None, 0), eager=True, enc_embeds=f)
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert len(stub_graphs) == 2
    assert not np.array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("name", [NAME, "xlstm-350m-smoke"])
def test_consecutive_jobs_on_one_engine_equal_fresh_engines(name):
    """The second job on one engine reads caches the first wrote (the xLSTM
    states, the cross K/V): it must give what a fresh engine gives."""
    _, cfg = {**CONFIGS, **ENC_CONFIGS}[name]()
    first, second = (_tokens(seed, (2, 12), cfg.vocab) for seed in (11, 12))
    frames = [_frames(seed, cfg, 2) for seed in (13, 14)]

    def engine():
        return ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=2, device="cpu")

    eng = engine()
    ptrs = [t.data_ptr() for c in eng._state().caches for pair in c.values() for t in pair]
    got = [eng.generate(p, 6, enc_embeds=f)[0]
           for p, f in ((first, frames[0]), (second, frames[1]), (first, frames[0]))]
    want = [engine().generate(p, 6, enc_embeds=f)[0]
            for p, f in ((first, frames[0]), (second, frames[1]))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[0])
    assert [t.data_ptr() for c in eng._static.caches for pair in c.values() for t in pair] == ptrs


def test_reset_zeroes_the_cross_kv():
    _, cfg = ENC_CONFIGS[NAME]()
    eng = ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=1, device="cpu")
    eng.generate(_tokens(3, (2, 8), cfg.vocab), 2, enc_embeds=_frames(4, cfg, 2))
    cross = [t for c in eng._static.caches for t in c["cross_kv"]]
    assert len(cross) == 2 * cfg.n_layers and all(bool(t.any()) for t in cross)
    eng.model.reset_caches(eng._static.caches, eng._static.cache_len)
    assert not any(bool(t.any()) for t in cross)

