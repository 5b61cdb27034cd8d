"""``chip_smoke.py``'s launch accounting against what the model launches, on
the CPU.

The card's run holds every kernel counter of a main path to
``expected_launches`` and times each pinned-matmul shape of
``matmul_calls``.  Here each arch's smoke config serves the same rounds
through a CPU ``ServingEngine`` (a small batch, prompt and token count set
in the script's module), with the wrappers the model calls
(``ops.pinned_matmul``, ``ops.mha_flash``, ``ops.mamba_scan``) counting
their calls: the (M, K, N, dtype) of every projection must equal
``matmul_calls``, and the attention and scan calls ``expected_launches``.
The float32 check's block-at-a-time reference equals the whole prefill.
"""
from __future__ import annotations

import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServingEngine

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for name, value in (("BATCH", 2), ("PROMPT", 8), ("NEW_TOKENS", 3), ("ROUNDS", 2)):
        monkeypatch.setattr(module, name, value)
    return module


def _counting(monkeypatch):
    """Count the model's calls of each kernel wrapper; matmuls by shape."""
    matmuls, calls = collections.Counter(), collections.Counter()
    pinned, flash, scan = ops.pinned_matmul, ops.mha_flash, ops.mamba_scan

    def pinned_matmul(x, w, **kw):
        matmuls[(x.shape[0], x.shape[1], w.shape[1], str(x.dtype).removeprefix("torch."))] += 1
        return pinned(x, w, **kw)

    def mha_flash(*args, **kw):
        calls["flash_attention"] += 1
        return flash(*args, **kw)

    def mamba_scan(*args, **kw):
        calls["selective_scan"] += 1
        return scan(*args, **kw)

    monkeypatch.setattr(ops, "pinned_matmul", pinned_matmul)
    monkeypatch.setattr(ops, "mha_flash", mha_flash)
    monkeypatch.setattr(ops, "mamba_scan", mamba_scan)
    return matmuls, calls


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_expected_launches_are_the_main_paths(arch, monkeypatch):
    smoke = _chip_smoke(monkeypatch)
    cfg = get_smoke_config(arch)
    eng = ServingEngine(cfg, ServeConfig(max_context=smoke.max_context(cfg), batch=smoke.BATCH),
                        seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (smoke.BATCH, smoke.PROMPT)).astype(np.int32)
               for _ in range(smoke.ROUNDS)]
    matmuls, calls = _counting(monkeypatch)
    for p in prompts:
        eng.generate(p, smoke.NEW_TOKENS)
    assert dict(matmuls) == smoke.matmul_calls(cfg)
    expected = smoke.expected_launches(cfg)
    assert expected["persistent_matmul"] == sum(matmuls.values())
    assert {k: calls[k] for k in ("flash_attention", "selective_scan")} == \
        {k: expected[k] for k in ("flash_attention", "selective_scan")}
    per_prefill = collections.Counter(smoke.prefill_kernels(cfg))
    assert sum(per_prefill.values()) == sum(smoke.step_matmuls(cfg, True).values()) + \
        expected["flash_attention"] // smoke.ROUNDS


def test_whisper_prefill_carries_the_encoder_rows(monkeypatch):
    """The encoder's projections and the cross K/V run once a prefill at
    BATCH x enc_ctx rows; a decode step runs none of them."""
    smoke = _chip_smoke(monkeypatch)
    cfg = get_smoke_config("whisper-base")
    rows = smoke.BATCH * cfg.enc_ctx
    prefill, decode = smoke.step_matmuls(cfg, True), smoke.step_matmuls(cfg, False)
    assert sum(n for (m, *_), n in prefill.items() if m == rows) == \
        7 * cfg.n_enc_layers + 2 * cfg.n_layers
    assert all(m == smoke.BATCH for m, *_ in decode)


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-350m", "jamba-v0.1-52b", "internvl2-2b"])
def test_one_block_at_a_time_equals_the_prefill(arch, monkeypatch):
    """The float32 check's reference (``prefill_f32``: each block, the
    encoder's first, cast and run alone) gives a float32 model's own
    prefill logits, and each block's error against it is 0 there."""
    smoke = _chip_smoke(monkeypatch)
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu")
    model.init_params(3)
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, smoke.PROMPT)))
    extra, frames = (torch.as_tensor(rng.standard_normal((2, n, cfg.d_model)) * 0.02,
                                     dtype=torch.float32) if n else None
                     for n in (cfg.n_patches, cfg.enc_ctx))
    with torch.inference_mode():
        want, _ = model.prefill(tokens, model.init_caches(2, smoke.max_context(cfg)), extra,
                                frames)
        got, errs = smoke.prefill_f32(model, tokens, extra, frames)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert len(errs) == cfg.n_layers + cfg.n_enc_layers
    assert [e["layer"] for e in errs[:cfg.n_enc_layers]] == [f"enc{i}" for i in
                                                             range(cfg.n_enc_layers)]
    assert all(e["kernels"] < 1e-6 and e["plain"] < 1e-6 for e in errs)


def test_train_phase_configs(monkeypatch):
    """The training phase's runs: the JAX example's qwen3-100m in float32
    for 200 steps, and qwen3-0.6b at full width (the registry's config, bf16)
    for 20."""
    from repro_torch.configs import get_config

    smoke = _chip_smoke(monkeypatch)
    runs = smoke.train_configs()
    assert list(runs) == ["qwen3-100m", "qwen3-0.6b"]
    cfg, steps, opt = runs["qwen3-100m"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
            cfg.dtype, cfg.tie_embeddings, cfg.qk_norm) == \
        (12, 768, 12, 4, 2048, 8192, "float32", True, True)
    assert (steps, opt.lr, opt.warmup_steps, opt.total_steps) == (200, 6e-4, 20, 200)
    cfg, steps, opt = runs["qwen3-0.6b"]
    assert cfg == get_config("qwen3-0.6b") and cfg.dtype == "bfloat16"
    assert (cfg.n_layers, cfg.vocab, steps) == (28, 151936, 20)
    assert (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ) == (8, 256)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b"])
def test_train_run_calls_no_kernel_wrapper(arch, monkeypatch):
    """A shrunk training run on the CPU: finite losses and grad norms, and
    neither a kernel launch nor a call of a kernel wrapper."""
    from repro_torch.train.optimizer import AdamWConfig

    smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 16)
    matmuls, calls = _counting(monkeypatch)
    model, opt, rec = smoke.train_run(get_smoke_config(arch), 3, AdamWConfig(warmup_steps=1),
                                      device="cpu")
    assert not matmuls and not calls
    assert rec["launches"] == {"persistent_matmul": 0, "flash_attention": 0, "selective_scan": 0}
    assert len(rec["losses"]) == len(rec["grad_norms"]) == 3 and int(opt.step) == 3
    assert all(p.grad is not None for n, p in model.named_parameters() if "np" not in n)


def test_sampler_chi2_passes_the_sampler_and_fails_a_uniform_one(monkeypatch):
    """The top-k phase's chi-square check on the CPU at a small vocabulary:
    ``sample_topk`` passes it by key and by step, every draw in the top k;
    a sampler uniform over the top k fails it."""
    from repro_torch.serving import engine as serving_engine

    smoke = _chip_smoke(monkeypatch)
    logits = torch.randn((2, 1000), generator=torch.Generator().manual_seed(0)) * 2.0
    for by in ("key", "step"):
        rows = smoke.sampler_chi2(logits, 2048, by, chunk=512)
        assert len(rows) == 2
        assert all(r["outside"] == 0 and r["dof"] > 0 and r["p"] >= smoke.TOPK_P_MIN
                   for r in rows), rows
    topk = serving_engine.sample_topk

    def uniform(key, logits, k=40, temperature=0.8, step=0):
        return topk(key, torch.zeros_like(logits).scatter(
            -1, torch.topk(logits, k, dim=-1).indices, 1.0), k, temperature, step)

    monkeypatch.setattr(serving_engine, "sample_topk", uniform)
    assert all(r["p"] < 1e-6 for r in smoke.sampler_chi2(logits, 2048, "key", chunk=512))
