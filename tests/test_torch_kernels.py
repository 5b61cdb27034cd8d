"""The port's kernel layer (repro_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
CUDA kernels themselves run only on the card (the last tests here skip
without one; ``chip_smoke.py`` exercises them at the main path's shapes).
Inputs are made with numpy from a seed and fed to both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import persistent_matmul as jpm
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.selective_scan import selective_scan as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_gqa
from repro_torch.kernels.flash_attention import kernel_name as flash_kernel_name
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.persistent_matmul import (
    WGMMA_K,
    kernel_name,
    persistent_matmul,
    persistent_matmul_traced,
    stage_rows,
    tile_grid,
    tile_of,
    unit_of,
)

_BF16, _F32 = torch.bfloat16, torch.float32
# (M, K, N, dtype) of the split launches on the two main paths: decode
# (M = 4) for qwen3-0.6b and jamba-v0.1-52b, jamba's x_proj and router
_PATH_SHAPES = [(4, 1024, 1024, _BF16), (4, 1024, 3072, _BF16), (4, 3072, 1024, _BF16),
                (4, 4096, 4096, _BF16), (4, 4096, 14336, _BF16), (4, 14336, 4096, _BF16),
                (4, 8192, 33, _BF16), (4, 4096, 16, _F32), (512, 8192, 33, _BF16),
                (1024, 4096, 16, _F32)]
# the wide bf16 prefill projections of both main paths (qwen3-0.6b, then
# jamba-v0.1-52b), all on the wgmma variant
_WIDE_SHAPES = [(1024, 1024, 1024, _BF16), (1024, 1024, 2048, _BF16), (1024, 1024, 3072, _BF16),
                (1024, 2048, 1024, _BF16), (1024, 3072, 1024, _BF16),
                (1024, 4096, 1024, _BF16), (1024, 4096, 4096, _BF16), (1024, 4096, 14336, _BF16),
                (1024, 4096, 16384, _BF16), (1024, 8192, 4096, _BF16), (1024, 14336, 4096, _BF16)]
# K not a multiple of the slice; N narrow, odd, or past one decode unit
_RAGGED_SHAPES = [(3, 1000, 33, _BF16), (4, 200, 130, _F32), (100, 1000, 16, _F32),
                  (512, 1000, 33, _BF16), (4, 1000, 600, _BF16)]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a, dtype="float32"):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


class TestPinnedMatmulParity:
    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
    @pytest.mark.parametrize(
        "m,k,n,bands", [(256, 128, 256, 2), (512, 256, 512, 4), (128, 384, 256, 1)]
    )
    def test_matches_pallas(self, m, k, n, bands, dtype, tol):
        xj, xt = _both(_rand(0, (m, k)), dtype)
        wj, wt = _both(_rand(1, (k, n)), dtype)
        want = _np(jpm.persistent_matmul(xj, wj, n_bands=bands, interpret=True))
        for got in (ref.matmul_ref(xt, wt), ops.pinned_matmul(xt, wt, n_bands=bands)):
            np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * 8)

    def test_matches_jax_ops_on_the_model_widths(self):
        # qwen3-0.6b smoke widths: d=256, q/kv = 256/128, d_ff = 512
        for k, n in [(256, 256), (256, 128), (256, 512), (512, 256)]:
            xj, xt = _both(_rand(k, (64, k)))
            wj, wt = _both(_rand(n, (k, n)))
            want = np.asarray(jops.pinned_matmul(xj, wj, interpret=True))
            got = ops.pinned_matmul(xt, wt).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=8e-4)

    def test_odd_shapes(self):
        """The JAX wrapper falls back to x @ w; the port has no such rule."""
        xj, xt = _both(_rand(2, (96, 80)))
        wj, wt = _both(_rand(3, (80, 112)))
        want = np.asarray(jops.pinned_matmul(xj, wj, interpret=True))
        np.testing.assert_allclose(ops.pinned_matmul(xt, wt).numpy(), want,
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("n,target", [(256, 256), (384, 256), (96, 128), (7, 4), (1, 8)])
    def test_pick_block_matches_jax(self, n, target):
        assert ops._pick_block(n, target) == jops._pick_block(n, target)


class TestTileMap:
    @pytest.mark.parametrize("m,n,bands", [(256, 256, 2), (512, 512, 4), (1024, 512, 8),
                                           (128, 1024, 1)])
    def test_tile_of_equals_jax_map(self, m, n, bands, monkeypatch):
        """Capture the out_spec index map that the Pallas kernel gives
        pallas_call and hold the port's tile_of to it."""
        captured = {}

        def fake_pallas_call(kernel, *, grid, out_specs, out_shape, **kw):
            captured["grid"], captured["map"] = grid, out_specs.index_map
            return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

        monkeypatch.setattr(jpm.pl, "pallas_call", fake_pallas_call)
        x = jnp.zeros((m, 128), jnp.float32)
        w = jnp.zeros((128, n), jnp.float32)
        jpm.persistent_matmul.__wrapped__(x, w, n_bands=bands)
        n_bands, lanes, per_lane, _ = captured["grid"]
        assert (n_bands, lanes) == (bands, 2)
        n_tiles_n = n // 128
        for b in range(n_bands):
            for lane in range(2):
                for step in range(per_lane):
                    want = tuple(int(i) for i in captured["map"](b, lane, step, 0))
                    assert tile_of(b, lane, step, per_lane, n_tiles_n) == want

    @staticmethod
    def _units_by_band(m, k, n, dtype, bands):
        """Every (row tile, col tile, K slice) the lanes walk, with its band,
        checked to lie inside the band's contiguous range."""
        g = tile_grid(m, k, n, dtype, bands)
        seen = {}
        for b in range(bands):
            for lane in range(2):
                for step in range(g.per_lane):
                    linear = b * 2 * g.per_lane + step * 2 + lane
                    if linear >= g.units:
                        continue  # masked by the kernel
                    assert tile_of(b, lane, step, g.per_lane, g.n_tiles_n) == \
                        (linear // g.n_tiles_n, linear % g.n_tiles_n)
                    unit = unit_of(linear, g.n_tiles_n, g.n_slices)
                    assert unit not in seen
                    seen[unit] = b
                    assert b * 2 * g.per_lane <= linear < (b + 1) * 2 * g.per_lane
        rows, cols = -(-m // g.block_m), g.n_tiles_n
        assert set(seen) == {(r, c, s) for r in range(rows) for c in range(cols)
                             for s in range(g.n_slices)}
        return g

    @pytest.mark.parametrize("bands", [1, 2, 4, 8])
    @pytest.mark.parametrize("m,n", [(4, 1024), (4, 3072), (1024, 2048), (100, 130)])
    def test_every_tile_once_inside_its_band(self, m, n, bands):
        """Every work unit exactly once, inside its band's range (K = 1000
        is split wherever the tiles are few)."""
        self._units_by_band(m, 1000, n, torch.bfloat16, bands)

    @pytest.mark.parametrize("bands", [1, 2, 4, 8])
    @pytest.mark.parametrize("m,k,n,dtype", _PATH_SHAPES)
    def test_every_unit_once_at_the_path_shapes(self, m, k, n, dtype, bands):
        g = self._units_by_band(m, k, n, dtype, bands)
        assert g.n_slices > 1  # these shapes have too few tiles to fill the card

    @pytest.mark.parametrize("m,k,n,dtype", _PATH_SHAPES + _WIDE_SHAPES + _RAGGED_SHAPES)
    def test_slice_plan_depends_on_the_shape_alone(self, m, k, n, dtype):
        """The same slices for every band count; they cover [0, K) exactly in
        multiples of the K step, the last one ragged; no split where the
        tiles fill the card's 2 x 132 lanes."""
        plans = {(g.n_slices, g.slice_len, g.k_step, g.tiles)
                 for g in (tile_grid(m, k, n, dtype, b) for b in (1, 2, 8, 132))}
        assert len(plans) == 1
        n_slices, slice_len, k_step, tiles = plans.pop()
        assert slice_len % k_step == 0
        assert (n_slices - 1) * slice_len < k <= n_slices * slice_len
        if tiles >= 2 * 132:
            assert n_slices == 1
        if (m, k, n, dtype) in _WIDE_SHAPES:  # the wgmma variant and its K step
            assert kernel_name(m, k, n, dtype) == "pinned_wgmma_kernel"
            assert k_step == WGMMA_K

    @pytest.mark.parametrize("bands", [1, 2, 8, 132])
    @pytest.mark.parametrize("m,k,n,dtype", _WIDE_SHAPES)
    def test_every_unit_once_at_the_wide_shapes(self, m, k, n, dtype, bands):
        g = self._units_by_band(m, k, n, dtype, bands)
        assert (g.block_m, g.block_n, g.k_step) == (128, 128, WGMMA_K)

    @pytest.mark.parametrize("m,k,n,dtype,kernel", [
        (512, 8192, 33, _BF16, "pinned_mma_kernel"),     # x_proj: N % 8 != 0
        (100, 200, 130, _BF16, "pinned_mma_kernel"),     # ragged N
        (100, 1000, 130, _BF16, "pinned_mma_kernel"),
        (100, 1001, 136, _BF16, "pinned_mma_kernel"),    # K % 8 != 0
        (100, 200, 136, _BF16, "pinned_wgmma_kernel"),   # ragged but TMA-strided
        (1000, 1000, 1032, _BF16, "pinned_wgmma_kernel"),
        (17, 64, 8, _BF16, "pinned_wgmma_kernel"),
        (16, 1024, 1024, _BF16, "pinned_matmul_kernel"),  # 4 < M <= 16
        (1024, 1024, 1024, _F32, "pinned_matmul_kernel"),
        (1024, 4096, 16, _F32, "pinned_matmul_kernel"),  # the router
        (4, 4096, 4096, _BF16, "pinned_gemv_kernel"),
    ])
    def test_variant_follows_from_shape_and_type(self, m, k, n, dtype, kernel):
        """Only bf16 with M > 16 and 16-byte row strides takes the wgmma
        variant; the choice is the same at every band count."""
        assert kernel_name(m, k, n, dtype) == kernel
        grids = {tile_grid(m, k, n, dtype, b) for b in (1, 2, 8, 132)}
        assert len({(g.block_m, g.block_n, g.k_step, g.n_slices, g.slice_len) for g in grids}) == 1

    def test_stage_rows_keep_slabs_aligned(self):
        """A decode stage is 16 KB at most and a multiple of 8 rows, so every
        slab of w (rows x N) starts on a 16-byte boundary whatever N is."""
        for itemsize in (2, 4):
            for n in (1, 16, 33, 100, 256, 257, 4096):
                rows = stage_rows(n, itemsize)
                assert rows % 8 == 0 and 8 <= rows <= 128
                assert rows * min(n, 512 // itemsize) * itemsize <= 16384


class TestFlashParity:
    @pytest.mark.parametrize("window", [None, 64])
    @pytest.mark.parametrize("s,qb", [(256, 128), (384, 128)])
    def test_ref_matches_pallas(self, s, qb, window):
        bh, hd = 4, 64
        (qj, qt), (kj, kt), (vj, vt) = (_both(_rand(i, (bh, s, hd))) for i in range(3))
        want = np.asarray(jflash(qj, kj, vj, scale=hd ** -0.5, window=window,
                                 q_block=qb, kv_block=qb, interpret=True))
        got = ref.flash_attention_ref(qt, kt, vt, scale=hd ** -0.5, window=window)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("window", [None, 64])
    def test_mha_flash_gqa_matches_jax_ops(self, window):
        b, s, h, hkv, hd = 2, 256, 8, 2, 32
        qj, qt = _both(_rand(4, (b, s, h, hd)))
        kj, kt = _both(_rand(5, (b, s, hkv, hd)))
        vj, vt = _both(_rand(6, (b, s, hkv, hd)))
        want = np.asarray(jops.mha_flash(qj, kj, vj, scale=hd ** -0.5, window=window,
                                         interpret=True))
        got = ops.mha_flash(qt, kt, vt, scale=hd ** -0.5, window=window)
        assert got.shape == (b, s, h * hd)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("s,hd", [(256, 32), (256, 128), (200, 64), (77, 128)])
    @pytest.mark.parametrize("window", [None, 64])
    @pytest.mark.parametrize("group", [1, 2, 4])
    def test_mha_flash_ref_matches_jax_ops(self, group, window, s, hd):
        """The [B, S, H, hd] function the kernel computes: mha_flash_ref and
        ops.mha_flash on the CPU against the JAX wrapper over the Pallas
        kernel, at group ratios 1, 2 and 4, with and without a window, at a
        full and a ragged S."""
        b, hkv = 1, 2
        h = group * hkv
        qj, qt = _both(_rand(10 + s, (b, s, h, hd)))
        kj, kt = _both(_rand(11 + hd, (b, s, hkv, hd)))
        vj, vt = _both(_rand(12 + group, (b, s, hkv, hd)))
        want = np.asarray(jops.mha_flash(qj, kj, vj, scale=hd ** -0.5, window=window,
                                         interpret=True))
        got = ref.mha_flash_ref(qt, kt, vt, scale=hd ** -0.5, window=window)
        assert got.shape == (b, s, h * hd)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        assert torch.equal(ops.mha_flash(qt, kt, vt, scale=hd ** -0.5, window=window), got)

    def test_bf16_ref_matches_jax_ref(self):
        bh, s, hd = 2, 128, 32
        (qj, qt), (kj, kt), (vj, vt) = (_both(_rand(7 + i, (bh, s, hd)), "bfloat16")
                                        for i in range(3))
        want = _np(jref.flash_attention_ref(qj, kj, vj, scale=hd ** -0.5))
        got = _np(ref.flash_attention_ref(qt, kt, vt, scale=hd ** -0.5))
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def _scan_inputs(seed, b, s, d, n):
    """tests/test_kernels.py::TestSelectiveScan's inputs, made with numpy."""
    abar = 1.0 / (1.0 + np.exp(-_rand(seed, (b, s, d, n))))  # stable
    return abar.astype(np.float32), _rand(seed + 1, (b, s, d, n)) * 0.1, _rand(seed + 2, (b, s, n))


class TestSelectiveScanParity:
    @pytest.mark.parametrize("s,d,n", [(64, 32, 8), (128, 64, 16), (96, 48, 4)])
    def test_ref_matches_pallas(self, s, d, n):
        (aj, at), (bj, bt), (cj, ct) = (_both(a) for a in _scan_inputs(0, 2, s, d, n))
        want = np.asarray(jscan(aj, bj, cj, chunk=32, d_block=16, interpret=True))
        y, h = ref.selective_scan_ref(at, bt, ct)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
        y_ops, h_ops = ops.mamba_scan(at, bt, ct)
        assert torch.equal(y_ops, y) and torch.equal(h_ops, h)

    @pytest.mark.parametrize("split", [1, 37, 64])
    def test_state_carried_across_a_split_is_the_whole_scan(self, split):
        """The final state and h0 chain two scans into one, as the model's
        time chunks do."""
        at, bt, ct = (torch.from_numpy(a) for a in _scan_inputs(3, 2, 96, 24, 16))
        y, h = ref.selective_scan_ref(at, bt, ct)
        y1, h1 = ref.selective_scan_ref(at[:, :split], bt[:, :split], ct[:, :split])
        y2, h2 = ref.selective_scan_ref(at[:, split:], bt[:, split:], ct[:, split:], h1)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-6, atol=1e-6)

    def test_chunked_carry_matches_jax_ssm_scan_chunked(self):
        """At the jamba smoke config: the port's chunked scan (the state
        handed from chunk to chunk through ops.mamba_scan) against JAX
        ssm_scan_chunked's y without d_skip and its h_final, and against
        the Pallas kernel on JAX's own abar/bx."""
        import jax

        from repro.configs import get_smoke_config as jax_smoke_config
        from repro.models.mamba import _ssm_params, init_mamba
        from repro.models.mamba import ssm_scan_chunked as jax_chunked
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.mamba import Mamba, ssm_scan_chunked

        jcfg = jax_smoke_config("jamba-v0.1-52b")
        params = init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
        mixer = Mamba(get_smoke_config("jamba-v0.1-52b"), torch.float32, "cpu")
        mixer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
        xcj, xct = _both(_rand(9, (2, 64, jcfg.d_inner)) * 0.1)

        y_jax, h_jax = jax_chunked(params, xcj, chunk=16)
        y_jax = np.asarray(y_jax - xcj * params["d_skip"])
        with torch.inference_mode():
            y, h = ssm_scan_chunked(mixer, xct, chunk=16)
        np.testing.assert_allclose((y - xct * mixer.d_skip).numpy(), y_jax, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_jax), rtol=1e-4, atol=1e-4)

        abar, bx, c_t = _ssm_params(params, xcj)
        y_pallas = jscan(abar, bx, c_t, chunk=16, d_block=64, interpret=True)
        np.testing.assert_allclose(y_jax, np.asarray(y_pallas), rtol=1e-4, atol=1e-4)


class TestWrappers:
    def test_cpu_calls_leave_launch_counters_at_zero(self):
        x, w = torch.randn(8, 16), torch.randn(16, 24)
        ops.pinned_matmul(x, w)
        q = torch.randn(1, 64, 2, 32)
        ops.mha_flash(q, q, q, scale=0.1)
        assert persistent_matmul.launches == 0
        assert flash_attention.launches == 0

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        x = torch.randn(8, 16)
        with pytest.raises(ValueError):
            persistent_matmul(x, torch.randn(16, 8))
        with pytest.raises(ValueError):
            flash_attention(torch.randn(1, 8, 32), torch.randn(1, 8, 32),
                            torch.randn(1, 8, 32), scale=0.1)

    @pytest.mark.parametrize("case", ["cpu", "group", "last_dim", "head_dim", "dtype", "shape",
                                      "stride"])
    def test_gqa_wrapper_refuses_what_the_kernel_does_not_take(self, case):
        """flash_attention_gqa raises (no copy, no launch) on CPU tensors, on
        H % Hkv != 0, on a non-contiguous last dimension, on an unsupported
        head dim or dtype, on mismatched shapes and on unaligned strides."""
        b, s, h, hkv, hd = 1, 16, 4, 2, 32
        q, k, v = torch.randn(b, s, h, hd), torch.randn(b, s, hkv, hd), torch.randn(b, s, hkv, hd)
        error, match = ValueError, None
        if case == "cpu":
            match = "CUDA"
        elif case == "group":
            q, match = torch.randn(b, s, 3, hd), "share"
        elif case == "last_dim":
            q, match = torch.randn(b, s, hd, h).transpose(2, 3), "contiguous"
        elif case == "head_dim":
            q, k, v = (torch.randn(b, s, n, 48) for n in (h, hkv, hkv))
            match = "head_dim"
        elif case == "dtype":
            q, k, v = (t.half() for t in (q, k, v))
            error = TypeError
        elif case == "shape":
            k, match = torch.randn(b, s + 1, hkv, hd), "B, S, Hkv, hd"
        else:  # a position stride of 130 floats: rows not 16-byte aligned
            q, match = torch.randn(b, s, h * hd + 2)[..., :h * hd].view(b, s, h, hd), "16-byte"
        with pytest.raises(error, match=match):
            flash_attention_gqa(q, k, v, scale=0.1)
        assert flash_attention.launches == 0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd", [32, 64, 128])
    def test_flash_kernel_name_covers_every_dtype_and_head_dim(self, dtype, hd):
        want = ("flash_f32_kernel" if dtype == torch.float32 else
                "flash_mma_kernel" if hd == 32 else "flash_wgmma_kernel")
        assert flash_kernel_name(dtype, hd) == want
        with pytest.raises(ValueError):
            flash_kernel_name(dtype, 48)
        with pytest.raises(ValueError):
            flash_kernel_name(torch.float16, hd)

    def test_mha_flash_hands_the_model_tensors_to_one_kernel_call(self, monkeypatch):
        """Off the CPU, ops.mha_flash is one call of flash_attention_gqa on
        the tensors as the model made them: no repeat, transpose or copy."""
        calls = []

        def entry(q, k, v, *, scale, window=None):
            calls.append((q, k, v, scale, window))
            return torch.empty(q.shape[0], q.shape[1], q.shape[2] * q.shape[3], device="meta")

        monkeypatch.setattr(ops, "flash_attention_gqa", entry)
        q = torch.empty(2, 16, 8, 64, device="meta")
        k, v = torch.empty(2, 16, 2, 64, device="meta"), torch.empty(2, 16, 2, 64, device="meta")
        out = ops.mha_flash(q, k, v, scale=0.125, window=8)
        assert len(calls) == 1 and out.shape == (2, 16, 512)
        assert calls[0][0] is q and calls[0][1] is k and calls[0][2] is v
        assert calls[0][3:] == (0.125, 8)

    def test_cpu_scan_leaves_its_launch_counter_at_zero(self):
        at, bt, ct = (torch.from_numpy(a) for a in _scan_inputs(4, 1, 8, 4, 16))
        y, h = ops.mamba_scan(at, bt, ct, torch.zeros(1, 4, 16))
        assert y.shape == (1, 8, 4) and h.shape == (1, 4, 16)
        assert selective_scan.launches == 0

    @pytest.mark.parametrize("with_h0", [False, True])
    def test_scan_wrapper_refuses_cpu_tensors(self, with_h0):
        at, bt, ct = (torch.from_numpy(a) for a in _scan_inputs(5, 1, 8, 4, 16))
        with pytest.raises(ValueError, match="CUDA"):
            selective_scan(at, bt, ct, torch.zeros(1, 4, 16) if with_h0 else None)
        assert selective_scan.launches == 0


class TestOnCard:
    """The CUDA kernels against their plain versions (needs a card)."""

    @staticmethod
    def _need_card():
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc: run python3 chip_smoke.py there")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_pinned_matmul_covers_every_tile_once(self, dtype):
        self._need_card()
        x = torch.randn(100, 200, device="cuda").to(dtype)
        w = torch.randn(200, 130, device="cuda").to(dtype)
        outs = []
        for bands in (1, 2, 8):
            out, trace = persistent_matmul_traced(x, w, bands)
            assert trace.tiles_done == trace.tile_hits.numel()
            assert bool((trace.tile_hits == 1).all())
            outs.append(out)
        assert all(torch.equal(o, outs[0]) for o in outs)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(outs[0].float(), ref.matmul_ref(x, w).float(),
                                   rtol=tol, atol=tol * 8)

    @pytest.mark.parametrize("m,k,n,dtype", _PATH_SHAPES[6:] + _RAGGED_SHAPES + [
        (4, 4096, 4096, _BF16)])
    def test_split_units_once_and_bit_identical(self, m, k, n, dtype):
        """Split launches: every unit once on its band's SMs at n_bands in
        {1, 2, 8}, bit-identical outputs, the existing case's tolerance."""
        self._need_card()
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dtype)
        outs = []
        for bands in (1, 2, 8):
            out, trace = persistent_matmul_traced(x, w, bands)
            g = tile_grid(m, k, n, dtype, bands)
            assert g.n_slices > 1
            assert trace.tiles_done == g.units == trace.tile_hits.numel()
            assert bool((trace.tile_hits == 1).all())
            owner = [trace.allowed_sms[u // (2 * g.per_lane)] for u in range(g.units)]
            assert trace.tile_sm.cpu().tolist() == owner
            outs.append(out)
        assert all(torch.equal(o, outs[0]) for o in outs)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(outs[0].float(), ref.matmul_ref(x, w).float(),
                                   rtol=tol, atol=tol * 8)

    @pytest.mark.parametrize("m,k,n", [(100, 200, 136), (1000, 1000, 1032), (1024, 1024, 1024),
                                       (1024, 4096, 4096)])
    def test_wgmma_variant_once_per_unit_and_bit_identical(self, m, k, n):
        """The wgmma variant against matmul_ref at eligible ragged and path
        shapes: every unit once on its band's SM at n_bands 1, 8 and 132,
        bit-identical outputs, also from a misaligned (copied) operand."""
        self._need_card()
        assert kernel_name(m, k, n, _BF16) == "pinned_wgmma_kernel"
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(m, k, generator=gen, device="cuda").to(_BF16)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(_BF16)
        outs = []
        for bands in (1, 8, 132):
            out, trace = persistent_matmul_traced(x, w, bands)
            g = tile_grid(m, k, n, _BF16, bands)
            assert trace.tiles_done == g.units == trace.tile_hits.numel()
            assert bool((trace.tile_hits == 1).all())
            owner = [trace.allowed_sms[u // (2 * g.per_lane)] for u in range(g.units)]
            assert trace.tile_sm.cpu().tolist() == owner
            outs.append(out)
        assert all(torch.equal(o, outs[0]) for o in outs)
        shifted = torch.empty(m * k + 1, device="cuda", dtype=_BF16)[1:].view(m, k)
        shifted.copy_(x)
        assert torch.equal(persistent_matmul(shifted, w), outs[0])
        torch.testing.assert_close(outs[0].float(), ref.matmul_ref(x, w).float(),
                                   rtol=1e-2, atol=1e-2)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
    @pytest.mark.parametrize("window", [None, 64])
    def test_flash_attention_matches_ref(self, window, dtype, tol):
        self._need_card()
        q, k, v = (torch.randn(3, 200, 64, device="cuda").to(dtype) for _ in range(3))
        got = flash_attention(q, k, v, scale=0.125, window=window)
        want = ref.flash_attention_ref(q, k, v, scale=0.125, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
    @pytest.mark.parametrize("window", [None, 64])
    @pytest.mark.parametrize("s", [256, 200])
    @pytest.mark.parametrize("group", [1, 2, 4])
    def test_flash_gqa_matches_ref(self, group, s, window, dtype, tol):
        """The [B, S, H, hd] entry against mha_flash_ref: group ratios 1, 2
        and 4, a ragged S, a window; the output read as [B, S, H * hd]."""
        self._need_card()
        gen = torch.Generator(device="cuda").manual_seed(group * 1000 + s)
        b, hkv, hd = 2, 2, 128
        q = torch.randn(b, s, group * hkv, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        got = flash_attention_gqa(q, k, v, scale=hd ** -0.5, window=window)
        assert got.shape == (b, s, group * hkv * hd)
        want = ref.mha_flash_ref(q, k, v, scale=hd ** -0.5, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    @pytest.mark.parametrize("hd", [32, 64, 128])
    @pytest.mark.parametrize("window", [None, 64])
    def test_flash_old_entry_bit_identical_to_new(self, window, hd):
        """The [BH, S, hd] entry on expanded, head-flattened inputs gives the
        very bits of the [B, S, H, hd] entry."""
        self._need_card()
        gen = torch.Generator(device="cuda").manual_seed(hd)
        b, s, h, hkv = 2, 200, 4, 2
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        new = flash_attention_gqa(q, k, v, scale=0.1, window=window)
        flat = [t.repeat_interleave(h // t.shape[2], 2).transpose(1, 2).reshape(b * h, s, hd)
                .contiguous() for t in (q, k, v)]
        old = flash_attention(*flat, scale=0.1, window=window)
        assert torch.equal(old, new.view(b, s, h, hd).transpose(1, 2).reshape(b * h, s, hd))

    @pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("s,d,n", [(1, 100, 16), (77, 300, 8), (200, 70, 4), (256, 512, 16)])
    def test_selective_scan_matches_ref(self, s, d, n, c_dtype):
        self._need_card()
        abar, bx, c = (torch.from_numpy(a).cuda() for a in _scan_inputs(6, 2, s, d, n))
        h0 = torch.randn(2, d, n, device="cuda")
        for h in (None, h0):
            got = selective_scan(abar, bx, c.to(c_dtype), h)
            want = ref.selective_scan_ref(abar, bx, c.to(c_dtype), h)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
