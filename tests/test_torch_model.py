"""The port's model (repro_torch.models) against the JAX model on the CPU.

JAX ``Model.init_params`` → numpy → ``repro_torch.convert`` → the port, in
float32: prefill logits and filled caches, then eight decode steps, must
match the JAX model path to 2e-4.  An encoder-decoder config (whisper)
gets the same frame embeddings, from a numpy seed, in both packages.
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LayerSpec as JLayerSpec
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models import LayerSpec, Model, ModelConfig

TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(**fields):
    """The same config in both packages."""
    pattern = fields.pop("pattern", (("attn", "mlp"),))
    return (JModelConfig(pattern=tuple(JLayerSpec(*p) for p in pattern), **fields),
            ModelConfig(pattern=tuple(LayerSpec(*p) for p in pattern), **fields))


def tiny_pair(n_repeats=2):
    """tests/test_train_serve.py::tiny_cfg in both packages."""
    return _pair(name="tiny", arch_type="dense", d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=128, vocab=256, n_repeats=n_repeats, tie_embeddings=True,
                 dtype="float32")


def smoke_pair(arch="qwen3-0.6b"):
    return jax_smoke_config(arch), get_smoke_config(arch)


def jamba_smoke_pair():
    """One Mamba layer with an MLP, one attention layer with an MoE."""
    return smoke_pair("jamba-v0.1-52b")


CONFIGS = {"tiny": tiny_pair, "qwen3-0.6b-smoke": smoke_pair,
           "jamba-v0.1-52b-smoke": jamba_smoke_pair,
           **{f"{arch}-smoke": functools.partial(smoke_pair, arch)
              for arch in ("qwen3-14b", "deepseek-7b", "olmo-1b", "phi3.5-moe-42b-a6.6b",
                           "dbrx-132b", "xlstm-350m")}}
# Configs with a prefix of patch embeddings: the serving engine always
# prepends them (zeros by default), so they are held to the JAX engine in
# tests/test_torch_configs.py, with the embeddings given to both.
PATCH_CONFIGS = {"internvl2-2b-smoke": functools.partial(smoke_pair, "internvl2-2b")}
# Encoder-decoder configs: the serving engine always encodes frame
# embeddings (zeros by default), so they are held to the JAX engine in
# tests/test_torch_encoder.py, with the embeddings given to both.
ENC_CONFIGS = {"whisper-base-smoke": functools.partial(smoke_pair, "whisper-base")}
MODEL_CONFIGS = {**CONFIGS, **PATCH_CONFIGS, **ENC_CONFIGS}


def _build(pair, seed=0):
    jcfg, tcfg = pair
    jm = JModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    model = Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jm, params, model


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _frames(seed, cfg, batch):
    """Frame embeddings [batch, enc_ctx, d_model] from a numpy seed for an
    encoder-decoder config; None for any other."""
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.enc_ctx, cfg.d_model)).astype(np.float32)


def _as(module, a):
    """A numpy array (or None) as the array type of ``module`` (jnp or torch)."""
    return None if a is None else (jnp.asarray(a) if module is jnp else torch.as_tensor(a))


def _assert_caches_equal(jax_caches, port_caches, cfg):
    want = caches_from_jax(jax.tree_util.tree_map(np.asarray, jax_caches), cfg)
    assert len(want) == len(port_caches) == cfg.n_layers
    for w, g in zip(want, port_caches):
        assert set(g) == set(w)
        for key in w:  # "kv": (k, v); "ssm": (conv, ssm)
            for got, exp in zip(g[key], w[key]):
                assert got.dtype == exp.dtype and got.shape == exp.shape
                np.testing.assert_allclose(got.numpy(), exp.numpy(), **TOL)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_config_copy_matches_jax(name):
    jcfg, tcfg = MODEL_CONFIGS[name]()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jcfg.param_count() == tcfg.param_count()


def test_full_config_matches_jax():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for arch in ("qwen3-0.6b", "jamba-v0.1-52b"):
        assert dataclasses.asdict(jax_get_config(arch)) == dataclasses.asdict(get_config(arch))
        assert jax_get_config(arch).param_count() == get_config(arch).param_count()


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_prefill_and_eight_decode_steps_match_jax(name):
    pair = MODEL_CONFIGS[name]()
    jcfg, tcfg = pair
    jm, params, model = _build(pair)
    b, s, max_len = 2, 20, 40
    toks = _tokens(1, (b, s), jcfg.vocab)
    frames = _frames(3, tcfg, b)

    jl, jc, _ = jm.prefill(params, jnp.asarray(toks), jm.init_caches(b, max_len), None,
                           _as(jnp, frames))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.as_tensor(toks), model.init_caches(b, max_len), None,
                               _as(torch, frames))
    assert tl.shape == (b, 1, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_equal(jc, tc, tcfg)

    cache_len = np.full((b,), s, np.int32)
    steps = _tokens(2, (8, b, 1), jcfg.vocab)
    for tok in steps:
        jl, jc = jm.decode_step(params, jnp.asarray(tok), jc, jnp.asarray(cache_len))
        with torch.inference_mode():
            tl, tc = model.decode_step(torch.as_tensor(tok), tc, torch.as_tensor(cache_len))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cache_len = cache_len + 1
    _assert_caches_equal(jc, tc, tcfg)


def test_decode_with_ragged_cache_lengths_matches_jax():
    """Rows at different lengths; the last write lands on the clipped slot."""
    pair = tiny_pair()
    jm, params, model = _build(pair, seed=3)
    b, s, max_len = 2, 10, 12
    toks = _tokens(4, (b, s), 256)
    _, jc, _ = jm.prefill(params, jnp.asarray(toks), jm.init_caches(b, max_len))
    with torch.inference_mode():
        _, tc = model.prefill(torch.as_tensor(toks), model.init_caches(b, max_len))
    cache_len = np.array([s - 3, s + 1], np.int32)
    for tok in _tokens(5, (3, b, 1), 256):
        jl, jc = jm.decode_step(params, jnp.asarray(tok), jc, jnp.asarray(cache_len))
        with torch.inference_mode():
            tl, tc = model.decode_step(torch.as_tensor(tok), tc, torch.as_tensor(cache_len))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cache_len = cache_len + 1
    _assert_caches_equal(jc, tc, pair[1])


def test_long_prompt_matches_jax_flash_branch():
    """S > 1024 takes JAX's _flash_sdpa; the port's path is the same at every S."""
    pair = tiny_pair(n_repeats=1)
    jm, params, model = _build(pair, seed=5)
    b, s = 1, 1152
    toks = _tokens(6, (b, s), 256)
    jl, jc, _ = jm.prefill(params, jnp.asarray(toks), jm.init_caches(b, s + 8))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.as_tensor(toks), model.init_caches(b, s + 8))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_equal(jc, tc, pair[1])


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_prefill_matches_jax_forward_train(name):
    """Mirror of tests/test_train_serve.py::test_decode_matches_forward."""
    jm, params, model = _build(MODEL_CONFIGS[name](), seed=1)
    b, s = 2, 12
    toks = _tokens(7, (b, s), jm.cfg.vocab)
    frames = _frames(8, model.cfg, b)
    hidden, _ = jm.forward_train(params, jnp.asarray(toks), None, _as(jnp, frames))
    full_logits = np.asarray(jm._logits(params, hidden[:, -1:]))
    with torch.inference_mode():
        tl, _ = model.prefill(torch.as_tensor(toks), model.init_caches(b, 32), None,
                              _as(torch, frames))
    np.testing.assert_allclose(tl.numpy(), full_logits, **TOL)


def test_converted_weights_keep_the_jax_layout():
    jcfg, tcfg = tiny_pair()
    jm, params, model = _build((jcfg, tcfg))
    state = model.state_dict()
    for r in range(tcfg.n_repeats):
        np.testing.assert_array_equal(
            state[f"layers.{r}.mixer.wq"].numpy(),
            np.asarray(params["layers"][0]["mixer"]["wq"][r]))
        assert state[f"layers.{r}.ffn.w_down"].shape == (tcfg.d_ff, tcfg.d_model)
    np.testing.assert_array_equal(state["embed.w"].numpy(), np.asarray(params["embed"]["w"]))


def test_init_params_is_seeded():
    _, tcfg = tiny_pair()
    a, b, c = (Model(tcfg, device="cpu") for _ in range(3))
    a.init_params(0)
    b.init_params(0)
    c.init_params(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.mixer.wq"], sc["layers.0.mixer.wq"])
    # the JAX package's scales: embedding 0.02, dense d_in ** -0.5, norms 1
    assert abs(sa["embed.w"].std().item() - 0.02) < 2e-3
    assert abs(sa["layers.0.ffn.w_gate"].std().item() - tcfg.d_model ** -0.5) < 0.01
    assert torch.equal(sa["layers.0.norm1.w"], torch.ones(tcfg.d_model))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_on_the_cpu(arch):
    """Every arch of the repo is a port Model (smoke size), with its random
    weights from a seed finite."""
    model = Model(get_smoke_config(arch), device="cpu")
    model.init_params(0)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert hasattr(model, "encoder") == model.cfg.is_encoder_decoder


def test_no_module_refuses_a_layer_kind():
    models = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "models"
    for path in models.glob("*.py"):
        assert "NotImplementedError" not in path.read_text(), path.name


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tiny_pair()[1])


def test_jamba_prefill_moe_aux_matches_jax(monkeypatch):
    """Serving drops the MoE aux loss; recorded at each block, its sum is
    the JAX prefill's aux."""
    from repro_torch.models import blocks

    auxes = []
    ffn_apply = blocks._ffn_apply

    def recording(*args):
        x, aux = ffn_apply(*args)
        auxes.append(float(aux))
        return x, aux

    monkeypatch.setattr(blocks, "_ffn_apply", recording)
    jm, params, model = _build(jamba_smoke_pair(), seed=2)
    toks = _tokens(8, (2, 24), jm.cfg.vocab)
    _, _, want = jm.prefill(params, jnp.asarray(toks), jm.init_caches(2, 32))
    with torch.inference_mode():
        model.prefill(torch.as_tensor(toks), model.init_caches(2, 32))
    assert len(auxes) == model.cfg.n_layers and float(want) > 0
    np.testing.assert_allclose(sum(auxes), float(want), **TOL)
