"""The port's training path (repro_torch) against the JAX package's, on the CPU.

JAX ``Model.init_params`` → numpy → ``repro_torch.convert`` → the port, in
float32: ``Model.loss`` and every parameter's gradient must match
``jax.value_and_grad(model.loss)`` (loss to a relative 1e-5; each
gradient's largest error to 1e-4 of its largest entry), for every arch's
smoke config, at a sequence through JAX's blocked attention branch
(S > 1024), windowed, and across two Mamba scan chunks, all with the three
kernel wrappers made to raise: training launches no hand kernel.  AdamW
is held to JAX's step for step on identical gradients; the trainer and
``launch.train`` learn and run on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import cosine_lr as jcosine_lr
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, layers
from repro_torch.train.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adamw_update, cosine_lr, init_opt_state
from test_torch_model import MODEL_CONFIGS, _build, tiny_pair

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # max |port - jax| over max |jax|, per parameter


@pytest.fixture
def no_kernels(monkeypatch):
    """The three kernel wrappers raise if anything calls them."""
    def refuse(*_, **__):
        raise AssertionError("a hand-kernel wrapper was called in training")

    for name in ("pinned_matmul", "mha_flash", "mamba_scan"):
        monkeypatch.setattr(ops, name, refuse)


def _f32(pair, **fields):
    return tuple(dataclasses.replace(cfg, dtype="float32", **fields) for cfg in pair)


def _inputs(cfg, b, s, seed=1):
    """tokens, labels and (for patch or encoder configs) embeddings, numpy."""
    rng = np.random.default_rng(seed)
    tokens, labels = (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for _ in range(2))
    extra = {}
    if cfg.n_patches:
        extra["extra_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)
                                                    ).astype(np.float32)
    if cfg.is_encoder_decoder:
        extra["enc_embeds"] = rng.standard_normal((b, cfg.enc_ctx, cfg.d_model)
                                                  ).astype(np.float32)
    return tokens, labels, extra


def _assert_loss_and_grads_match(pair, b, s):
    jcfg, tcfg = pair
    jm, params, model = _build(pair)
    tokens, labels, extra = _inputs(jcfg, b, s)
    want_loss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels),
        **{k: jnp.asarray(v) for k, v in extra.items()}))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)

    model.requires_grad_(True)
    loss = model.loss(torch.as_tensor(tokens), torch.as_tensor(labels),
                      **{k: torch.as_tensor(v) for k, v in extra.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # unused leaf: JAX's zeros
        scale = want[name].abs().max().item()
        err = (got - want[name]).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_loss_and_grads_match_jax(name, no_kernels):
    _assert_loss_and_grads_match(_f32(MODEL_CONFIGS[name]()), b=2, s=16)


# (config, batch, seq, sliding window): JAX's blocked attention (S > 1024;
# 512-query x 1024-key blocks, and at 1280 its 320-position blocks with a
# window that masks whole blocks), the small path with a window, and Mamba's
# scan across two 128-step chunks with the state carried
LONG_CASES = {
    "blocked-2048": ("qwen3-0.6b-smoke", 1, 2048, None),
    "blocked-window-1280": ("qwen3-0.6b-smoke", 1, 1280, 300),
    "small-window-64": ("qwen3-0.6b-smoke", 2, 64, 5),
    "mamba-two-chunks-256": ("jamba-v0.1-52b-smoke", 1, 256, None),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_loss_and_grads_match_jax_at_length(case, no_kernels):
    name, b, s, window = LONG_CASES[case]
    _assert_loss_and_grads_match(_f32(MODEL_CONFIGS[name](), sliding_window=window), b, s)


@pytest.mark.parametrize("kernel, wrapper, stand_in, args", [
    ("persistent_matmul", "pinned_matmul", "persistent_matmul", [(4, 8), (8, 16)]),
    ("flash_attention", "mha_flash", "flash_attention_gqa", [(1, 8, 2, 4)] * 3),
    ("selective_scan", "mamba_scan", "selective_scan", [(1, 8, 4, 2)] * 2 + [(1, 8, 2)]),
])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel, wrapper, stand_in, args,
                                                         monkeypatch):
    """A tensor off the CPU (here on the meta device, a stand-in for CUDA)
    goes to the kernel: with grad mode on, an input that requires a
    gradient raises naming the kernel; without grad mode the kernel runs."""
    calls = []
    monkeypatch.setattr(ops, stand_in, lambda *a, **kw: calls.append(a) or "launched")
    fn = getattr(ops, wrapper)
    kw = {"scale": 0.5} if wrapper == "mha_flash" else {}
    tensors = [torch.empty(shape, device="meta") for shape in args]
    tensors[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match=kernel):
        fn(*tensors, **kw)
    assert not calls
    with torch.no_grad():
        assert fn(*tensors, **kw) == "launched"
    plain = [t.detach() for t in tensors]
    assert fn(*plain, **kw) == "launched" and len(calls) == 2


def _grads(params, rng, scale, dtype):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale, dtype), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_step_for_step(dtype):
    """Three steps on identical gradients, one below the clip and two above
    it: parameters, m, v, grad norm and lr as JAX's.  float32 parameters to
    1e-6; bf16 parameters to one bf16 step (at most 2**-7 relative), where
    the float32 update lands near a rounding boundary of both."""
    pair = tuple(dataclasses.replace(c, dtype=dtype) for c in tiny_pair())
    jcfg, tcfg = pair
    jm, params, model = _build(pair)
    model.requires_grad_(True)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    jopt, opt = jinit_opt_state(params), init_opt_state(model)
    rng = np.random.default_rng(5)
    for scale in (1e-3, 1.0, 3.0):
        grads = _grads(params, rng, scale, params["embed"]["w"].dtype)
        params, jopt, jm_ = jadamw_update(JAdamWConfig(**cfg_kw), params, grads, jopt)
        for name, g in params_from_jax(jax.tree_util.tree_map(np.asarray, grads), tcfg).items():
            dict(model.named_parameters())[name].grad = g
        opt, metrics = adamw_update(AdamWConfig(**cfg_kw), model, opt)
        assert int(opt.step) == int(jopt.step)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm_["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(metrics["lr"].item(), float(jm_["lr"]), rtol=1e-6)
        for half, tree in (("m", jopt.m), ("v", jopt.v)):
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), tcfg)
            for name, t in getattr(opt, half).items():
                torch.testing.assert_close(t, want[name], rtol=1e-5, atol=1e-9)
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
        tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
        for name, p in model.named_parameters():
            assert p.dtype == want[name].dtype
            torch.testing.assert_close(p.detach(), want[name], **tol)


def test_cosine_lr_matches_jax():
    cfg = dict(lr=6e-4, warmup_steps=20, total_steps=200)
    for step in (0, 1, 20, 110, 200, 250):
        got = cosine_lr(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        want = jcosine_lr(JAdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-12)


def _tiny_model(seed=0):
    model = Model(tiny_pair()[1], device="cpu")
    model.init_params(seed)
    return model


def test_loss_decreases():
    """tests/test_train_serve.py::test_loss_decreases through the port."""
    model = _tiny_model()
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    opt = init_opt_state(model)
    data = TokenPipeline(DataConfig(model.cfg.vocab, 32, 8))
    losses = []
    for i in range(30):
        t, l = data.batch(i)
        opt, loss, _ = launch_train.train_step(model, opt_cfg, opt, torch.as_tensor(t),
                                               torch.as_tensor(l))
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_train_serve.py::test_checkpoint_roundtrip through the port."""
    model = _tiny_model()
    opt = init_opt_state(model)
    save_checkpoint(tmp_path, 7, model, opt)
    assert latest_step(tmp_path) == 7
    other = _tiny_model(seed=1)
    step, other, opt2 = load_checkpoint(tmp_path / "step_00000007.msgpack", other,
                                        init_opt_state(other))
    assert step == 7 and int(opt2.step) == 0
    for (name, a), (_, b) in zip(model.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), name


def test_launch_train_on_the_cpu(tmp_path, capsys):
    losses = launch_train.train("qwen3-0.6b", steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
                                log_every=1, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert latest_step(tmp_path) == 3
    assert capsys.readouterr().out.count("loss ") == 3


def test_launch_train_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train("qwen3-0.6b", steps=1, batch=2, seq=16)


def test_training_leaves_serving_parameters_without_grad():
    """Parameters are created without gradients; only the trainer's own
    model switches them on."""
    model = Model(get_smoke_config("qwen3-0.6b"), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------------- remat


def _loss_and_grads(model, cfg, b=2, s=16, remat=True):
    """The loss and every parameter's gradient (zeros where unused) of one
    backward with ``model.remat`` set as given."""
    tokens, labels, extra = _inputs(cfg, b, s)
    model.remat = remat
    model.zero_grad(set_to_none=True)
    loss = model.loss(torch.as_tensor(tokens), torch.as_tensor(labels),
                      **{k: torch.as_tensor(v) for k, v in extra.items()})
    loss.backward()
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                           for n, p in model.named_parameters()}


def _f32_model(name, seed=0):
    cfg = _f32(MODEL_CONFIGS[name]())[1]
    model = Model(cfg, device="cpu")
    model.init_params(seed)
    return model.requires_grad_(True)


def test_model_remats_by_default():
    """JAX's ``Model.remat`` is True unless launch/steps overrides it."""
    assert Model(get_smoke_config("qwen3-0.6b"), device="cpu").remat is True


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_remat_loss_and_grads_equal_without_remat_bitwise(name, no_kernels):
    """Recomputing each repeat in backward changes no bit of the float32
    loss or of any gradient (the MoE aux loss carried through each repeat,
    the encoder outside the checkpoints)."""
    model = _f32_model(name)
    loss, grads = _loss_and_grads(model, model.cfg, remat=True)
    want_loss, want = _loss_and_grads(model, model.cfg, remat=False)
    assert torch.equal(loss, want_loss)
    bad = [n for n in want if not torch.equal(grads[n], want[n])]
    assert not bad, bad


@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "whisper-base-smoke"])
def test_remat_backward_recomputes_each_repeat_without_a_kernel(name, no_kernels,
                                                                monkeypatch):
    """Backward runs every repeat a second time, last first; each call
    starts outside ``plain_products`` (the repeat enters it itself), and no
    kernel wrapper is reached (each raises)."""
    model = _f32_model(name)
    calls = []
    repeat = Model._repeat_train

    def counted(self, r, *args):
        calls.append((r, layers._PLAIN.get()))
        return repeat(self, r, *args)

    monkeypatch.setattr(Model, "_repeat_train", counted)
    n = model.cfg.n_repeats
    _, grads = _loss_and_grads(model, model.cfg, remat=True)
    assert calls == [(r, False) for r in [*range(n), *reversed(range(n))]]
    assert all(torch.isfinite(g).all() for g in grads.values())
    calls.clear()
    _loss_and_grads(model, model.cfg, remat=False)
    assert calls == [(r, False) for r in range(n)]


def _saved_bytes(model, b, s, remat) -> int:
    """Bytes of the tensors autograd saves for backward in one loss, each
    storage counted once (``saved_tensors_hooks``)."""
    tokens, labels, _ = _inputs(model.cfg, b, s)
    seen: dict = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    model.remat = remat
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(torch.as_tensor(tokens), torch.as_tensor(labels))
    return sum(seen.values())


@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "jamba-v0.1-52b-smoke"])
def test_remat_saves_fewer_bytes_for_backward(name):
    """With remat the repeats' activations are not saved: what autograd
    keeps for backward falls below half of what it keeps without."""
    model = _f32_model(name)
    with_remat, without = (_saved_bytes(model, 4, 64, remat) for remat in (True, False))
    assert 0 < 2 * with_remat < without, (with_remat, without)
