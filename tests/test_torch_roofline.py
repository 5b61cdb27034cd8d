"""The port's roofline (repro_torch.roofline) on the CPU: the analytic
MODEL_FLOPS and the report against the JAX package's, the counts of
``analyze_step`` against counts worked out by hand, the hand kernels'
meta counts against ``FlopCounterMode`` over their plain versions, the
step-loop weights against the whole loop, and what remat adds to a train
step's count (the recomputed forward) and takes from its peak.
"""
from __future__ import annotations

import contextlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import shape_config as jax_shape_config
from repro.models import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.roofline import HBM_BW as JAX_HBM_BW
from repro.roofline import LINK_BW as JAX_LINK_BW
from repro.roofline import PEAK_FLOPS as JAX_PEAK_FLOPS
from repro.roofline import model_flops as jax_model_flops
from repro.roofline import roofline_report as jax_roofline_report
from repro_torch import roofline
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_smoke_config, shape_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import causal_pairs
from repro_torch.kernels.ref import matmul_ref, mha_flash_ref, selective_scan_ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.dryrun import count_step
from repro_torch.launch.steps import build_bundle
from repro_torch.models import InputShape
from repro_torch.roofline import analyze_step, model_flops, roofline_report
from test_torch_launch import clean_process_state  # noqa: F401  (autouse fixture)

SUPPORTED = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES if shape_config(a, s) is not None]


@pytest.mark.parametrize("arch,shape_name", SUPPORTED)
def test_model_flops_match_jax(arch, shape_name):
    assert model_flops(shape_config(arch, shape_name), INPUT_SHAPES[shape_name]) == \
        jax_model_flops(jax_shape_config(arch, shape_name), JAX_INPUT_SHAPES[shape_name])


# synthetic per-device records: compute-, memory- and collective-heavy
RECORDS = [
    {"chips": 256, "flops_total": 3.1e15, "bytes_accessed": 2.0e11, "collective_bytes": 1.0e9},
    {"chips": 512, "flops_total": 1.0e12, "bytes_accessed": 7.5e12, "collective_bytes": 4.0e10},
    {"chips": 256, "flops_total": 2.0e12, "bytes_accessed": 1.0e9, "collective_bytes": 9.0e11},
    {"chips": 1, "flops_total": 0.0, "bytes_accessed": 1.0e6, "collective_bytes": 0.0},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_roofline_report_is_jaxs_on_the_h100_constants(i):
    record = RECORDS[i]
    cfg, shape = shape_config("qwen3-0.6b", "train_4k"), INPUT_SHAPES["train_4k"]
    jcfg, jshape = jax_shape_config("qwen3-0.6b", "train_4k"), JAX_INPUT_SHAPES["train_4k"]
    got, want = roofline_report(record, cfg, shape), jax_roofline_report(record, jcfg, jshape)
    ratio = {"compute_s": JAX_PEAK_FLOPS / roofline.PEAK_FLOPS,
             "memory_s": JAX_HBM_BW / roofline.HBM_BW,
             "collective_s": JAX_LINK_BW / roofline.LINK_BW}
    for term, r in ratio.items():
        assert got[term] == pytest.approx(want[term] * r, rel=1e-12)
    terms = {t: got[t] for t in ratio}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["step_time_lower_bound_s"] == max(terms.values())
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    if record["flops_total"]:
        assert got["mfu_upper_bound"] == pytest.approx(
            got["model_flops"] / (record["chips"] * roofline.PEAK_FLOPS)
            / got["step_time_lower_bound_s"], rel=1e-12)
    else:
        assert got["mfu_upper_bound"] is None


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_analyze_step_counts_a_dense_product_by_hand():
    m, k, n = 48, 64, 80
    x, w = torch.ones(m, k), torch.ones(k, n)
    stats, out = analyze_step(torch.matmul, x, w, params={"w": w})
    assert out.shape == (m, n)
    assert stats.flops == 2 * m * k * n
    assert stats.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert stats.products == {("w", 0): 4 * m * n}
    assert stats.temp_peak_bytes == 4 * m * n
    assert stats.collective_bytes == 0 and stats.collective_counts == {}
    # the parameter read transposed: the product contracts its dim 1
    stats, _ = analyze_step(lambda a: a @ w.T, torch.ones(m, n), params={"w": w})
    assert stats.products == {("w", 1): 4 * m * k}


def test_analyze_step_counts_the_hand_kernels_on_meta_by_hand():
    m, k, n = 256, 1024, 3072
    x, w = _meta(m, k), _meta(k, n)
    stats, out = analyze_step(ops.pinned_matmul, x, w, params={"w": w})
    assert out.device.type == "meta" and out.shape == (m, n) and out.dtype == torch.bfloat16
    assert stats.flops == 2 * m * k * n
    assert stats.bytes_accessed == 2 * (m * k + k * n + m * n)
    assert stats.products == {("w", 0): 2 * m * n}

    b, s, h, hkv, hd = 2, 256, 16, 8, 128
    q, kk, v = _meta(b, s, h, hd), _meta(b, s, hkv, hd), _meta(b, s, hkv, hd)
    for window, pairs in ((None, s * (s + 1) // 2), (64, 64 * 65 // 2 + (s - 64) * 64)):
        stats, out = analyze_step(ops.mha_flash, q, kk, v, scale=0.1, window=window)
        assert out.shape == (b, s, h * hd)
        assert stats.flops == 4 * b * h * hd * pairs  # QK^T and PV, 2 FLOPs a product
        assert stats.bytes_accessed == 2 * (2 * b * s * h * hd + 2 * b * s * hkv * hd)

    b, s, d, n = 2, 128, 512, 16
    abar, bx, c = _meta(b, s, d, n, dtype=torch.float32), _meta(b, s, d, n, dtype=torch.float32), \
        _meta(b, s, n)
    for h0 in (None, _meta(b, d, n, dtype=torch.float32)):
        stats, (y, h) = analyze_step(ops.mamba_scan, abar, bx, c, h0)
        assert y.shape == (b, s, d) and h.shape == (b, d, n)
        assert stats.flops == 4 * b * s * d * n  # h = abar*h + bx, y += c*h
        assert stats.bytes_accessed == 4 * (2 * b * s * d * n + b * s * d + b * d * n) \
            + 2 * b * s * n + (0 if h0 is None else 4 * b * d * n)


def _flop_counter(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def _meta_flops(fn, *args, **kw) -> float:
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    return analyze_step(fn, *meta, **kw)[0].flops


@pytest.mark.parametrize("m,k,n", [(4, 64, 96), (100, 200, 136)])
def test_pinned_matmul_meta_count_is_flop_counters(m, k, n):
    x, w = torch.randn(m, k), torch.randn(k, n)
    assert _meta_flops(ops.pinned_matmul, x, w) == _flop_counter(matmul_ref, x, w)


@pytest.mark.parametrize("s,window", [(64, None), (96, None), (64, 16)])
def test_mha_flash_meta_count_is_the_causal_share_of_flop_counters(s, window):
    """The plain version computes the full S x S square; the kernel the
    causal (or windowed) pairs: exactly causal_pairs / S^2 of it."""
    b, h, hkv, hd = 2, 4, 2, 32
    q, k, v = torch.randn(b, s, h, hd), torch.randn(b, s, hkv, hd), torch.randn(b, s, hkv, hd)
    plain = _flop_counter(mha_flash_ref, q, k, v, scale=0.2, window=window)
    assert plain == 4 * b * h * hd * s * s
    got = _meta_flops(ops.mha_flash, q, k, v, scale=0.2, window=window)
    assert got * s * s == plain * causal_pairs(s, window)
    if window is None:
        assert 2 * s * got == (s + 1) * plain


def test_mamba_scan_meta_count_and_flop_counters_blind_spot():
    """FlopCounterMode counts products only: the plain scan's elementwise
    updates and sums count 0 there, so the kernel's count is held to its
    hand count, 4 B S D N."""
    b, s, d, n = 2, 8, 16, 4
    abar, bx, c = torch.rand(b, s, d, n), torch.randn(b, s, d, n), torch.randn(b, s, n)
    assert _flop_counter(selective_scan_ref, abar, bx, c) == 0
    assert _meta_flops(ops.mamba_scan, abar, bx, c) == 4 * b * s * d * n


def test_wrappers_keep_cpu_on_the_plain_versions():
    x, w = torch.randn(8, 16), torch.randn(16, 24)
    torch.testing.assert_close(ops.pinned_matmul(x, w), matmul_ref(x, w), rtol=0, atol=0)


def _whole_loops(monkeypatch):
    monkeypatch.setattr(roofline, "step_loop", lambda n: contextlib.nullcontext(range(n)))
    monkeypatch.setattr(roofline, "loop_outputs", lambda outs, n: outs)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_step_loop_weights_equal_the_whole_loop(kind, monkeypatch):
    """xLSTM's mLSTM and sLSTM step loops, counted as three steps with the
    middle one weighted, count exactly what the whole loop counts: FLOPs,
    bytes and the parameters' products, forward and backward."""
    cfg = get_smoke_config("xlstm-350m")
    shape = InputShape("t", 24, 2, kind)
    with make_production_mesh() as mesh:
        _, weighted, _ = count_step(cfg, shape, mesh)
        _whole_loops(monkeypatch)
        _, whole, _ = count_step(cfg, shape, mesh)
    assert weighted.flops == whole.flops > 0
    assert weighted.bytes_accessed == whole.bytes_accessed
    assert weighted.products == whole.products


def test_step_loop_runs_every_step_outside_a_count():
    with roofline.step_loop(7) as steps:
        assert list(steps) == list(range(7))
    outs = [torch.tensor(float(i)) for i in range(7)]
    assert roofline.loop_outputs(outs, 7) is outs


def test_analyze_step_does_not_nest():
    with pytest.raises(RuntimeError, match="already counting"):
        analyze_step(analyze_step, torch.add, torch.ones(2), torch.ones(2))


def _train_count(arch, shape, remat, early_stop=True):
    """The meta train bundle of ``arch``'s smoke config with ``model.remat``
    as given, and the counts of its step; ``early_stop`` False makes each
    recompute run its repeat to the end."""
    with make_production_mesh() as mesh:
        bundle = build_bundle(get_smoke_config(arch), shape, mesh)
        bundle.model.remat = remat
        with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
            stats, _ = analyze_step(bundle.step_fn, *bundle.args, params=bundle.args[0])
    return bundle, stats


def _repeats_forward_flops(bundle) -> float:
    """The FLOPs of every repeat's forward alone, on the bundle's model."""
    model, cfg, shape = bundle.model, bundle.cfg, bundle.shape
    x = torch.empty((shape.global_batch, shape.seq_len + cfg.n_patches, cfg.d_model),
                    dtype=model.dtype, device="meta")
    enc = (torch.empty((shape.global_batch, cfg.enc_ctx, cfg.d_model), dtype=model.dtype,
                       device="meta") if cfg.is_encoder_decoder else None)

    def repeats():
        y, aux = x, torch.zeros((), device="meta")
        for r in range(cfg.n_repeats):
            y, aux = model._repeat_train(r, y, aux, enc)

    return analyze_step(repeats)[0].flops


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base", "xlstm-350m"])
def test_remat_train_count_grows_by_the_recomputed_forward(arch):
    """Remat adds each repeat's forward to the train step's FLOPs: exactly,
    when each recompute runs to the end; by less under torch's default
    early stop, which ends a recompute at the last tensor backward needs
    (xlstm's step loops weighted in the recompute as in the forward)."""
    shape = InputShape("t", 24, 2, "train")
    _, without = _train_count(arch, shape, remat=False)
    bundle, whole = _train_count(arch, shape, remat=True, early_stop=False)
    _, early = _train_count(arch, shape, remat=True)
    assert whole.flops == without.flops + _repeats_forward_flops(bundle)
    assert without.flops < early.flops <= whole.flops


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base"])
def test_remat_lowers_the_train_temp_peak(arch):
    """The dry run's ``temp_bytes`` source, the peak of live bytes the step
    made, falls with remat once activations outweigh the optimizer's
    temporaries (8 x 256 tokens at smoke width)."""
    shape = InputShape("t", 256, 8, "train")
    with_remat, without = (_train_count(arch, shape, remat)[1].temp_peak_bytes
                           for remat in (True, False))
    assert 0 < with_remat < without, (with_remat, without)
