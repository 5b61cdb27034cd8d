"""The serving engine's static caches and step graphs, on the CPU.

One engine's consecutive jobs reuse its caches and equal fresh engines'
jobs; the static-cache decode step matches the JAX package's
``Model.decode_step`` on exported parameters; the launch counters' replay
rule, checked on a stub graph; graphs keyed by prompt length and SM range
and captured off the job path, at admission and wherever a registration
or departure moves a service's SMs (a stub that replays by calling the
step); and the held-out script's counting and the pWCET's independence
statistics on synthetic walls.  Inputs come from numpy seeds; nothing
reads a clock.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.persistent_matmul import persistent_matmul
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.runtime import AdmissionController, ServingTaskSpec, serving_task_to_rt
from repro_torch.runtime.task_spec import independence
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving import engine as serving_engine
from repro_torch.serving.graphs import StepGraph, launch_counts

from test_torch_model import CONFIGS, TOL, _build, _tokens

REPO = Path(__file__).resolve().parents[1]
SMOKE = {"qwen3-0.6b-smoke": "qwen3-0.6b", "jamba-v0.1-52b-smoke": "jamba-v0.1-52b"}


def _holdout():
    spec = importlib.util.spec_from_file_location("pwcet_holdout",
                                                  REPO / "scripts" / "pwcet_holdout.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _engine(arch, batch=2, max_context=32, seed=0):
    return ServingEngine(get_smoke_config(arch), ServeConfig(max_context=max_context, batch=batch),
                         seed=seed, device="cpu")


# ------------------------------------------------------------ static caches


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_consecutive_jobs_on_one_engine_equal_fresh_engines(name):
    """The second job on one engine reads caches the first wrote (Mamba
    state and conv buffer included, for jamba's Mamba + MoE smoke config);
    it must give what a fresh engine gives."""
    arch = SMOKE[name]
    vocab = get_smoke_config(arch).vocab
    first, second = (_tokens(seed, (2, 12), vocab) for seed in (11, 12))
    eng = _engine(arch)
    caches = [t for c in eng._state().caches for pair in c.values() for t in pair]
    ptrs = [t.data_ptr() for t in caches]
    got = [eng.generate(p, 6)[0] for p in (first, second, first)]
    want = [_engine(arch).generate(p, 6)[0] for p in (first, second)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[0])
    assert [t.data_ptr() for t in caches] == ptrs
    assert not np.array_equal(want[0], want[1])


def test_reset_zeroes_the_mamba_state_and_cache_len():
    eng = _engine("jamba-v0.1-52b")
    eng.generate(_tokens(3, (2, 12), eng.cfg.vocab), 4)
    st = eng._static
    states = [t for c in st.caches for t in c.get("ssm", ())]
    assert states and all(bool(t.abs().sum() > 0) for t in states)
    assert st.cache_len.tolist() == [16, 16]
    eng.model.reset_caches(st.caches, st.cache_len)
    assert all(not bool(t.any()) for t in states) and not bool(st.cache_len.any())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_static_cache_decode_step_matches_jax(name):
    """The engine's own caches: prefill, then decode steps advancing
    ``cache_len`` in place, against the JAX model's functional decode on
    the same exported parameters, to test_torch_model's tolerance."""
    jcfg, tcfg = CONFIGS[name]()
    jm, params, _ = _build((jcfg, tcfg), seed=2)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    b, s, max_len = 2, 14, 40
    eng = ServingEngine(tcfg, ServeConfig(max_context=max_len, batch=b), params=state,
                        device="cpu")
    toks = _tokens(9, (b, s), jcfg.vocab)
    steps = eng.steps(s)
    st = eng._static
    st.prompts[s].copy_(torch.from_numpy(toks))
    steps.prefill()
    jl, jc, _ = jm.prefill(params, jnp.asarray(toks), jm.init_caches(b, max_len))
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    np.testing.assert_array_equal(st.tok.numpy(), jtok)
    ptrs = [t.data_ptr() for c in st.caches for pair in c.values() for t in pair]
    cache_len = np.full((b,), s, np.int32)
    for _ in range(6):
        jl, jc = jm.decode_step(params, jnp.asarray(jtok), jc, jnp.asarray(cache_len))
        with torch.inference_mode():
            tl, _ = eng.model.decode_step(st.tok, st.caches, st.cache_len)
            st.cache_len.add_(1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cache_len = cache_len + 1
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        st.tok.copy_(torch.from_numpy(jtok))
    assert st.cache_len.tolist() == cache_len.tolist()
    assert [t.data_ptr() for c in st.caches for pair in c.values() for t in pair] == ptrs


# ------------------------------------------------------------------- graphs


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_launches_its_capture_recorded():
    """A capture runs no kernel: the counts its step made are taken back and
    recorded; each replay adds them."""
    counters = {"persistent_matmul": persistent_matmul, "flash_attention": flash_attention,
                "selective_scan": selective_scan}
    saved = launch_counts()
    try:
        for fn in counters.values():
            fn.launches = 5

        def step():
            persistent_matmul.launches += 3
            flash_attention.launches += 1

        stub = _StubGraph()
        graph = StepGraph(step, graph=stub)
        assert graph.launches == {"persistent_matmul": 3, "flash_attention": 1,
                                  "selective_scan": 0}
        assert launch_counts() == {name: 5 for name in counters}
        for _ in range(4):
            graph.replay()
        assert stub.replays == graph.replays == 4
        assert launch_counts() == {"persistent_matmul": 17, "flash_attention": 9,
                                   "selective_scan": 5}

        def failing():
            persistent_matmul.launches += 2
            raise RuntimeError("capture failed")

        with pytest.raises(RuntimeError):
            StepGraph(failing, graph=_StubGraph())
        assert launch_counts()["persistent_matmul"] == 17
    finally:
        for name, fn in counters.items():
            fn.launches = saved[name]


class _EagerGraph:
    """A StepGraph stand-in that 'replays' by calling the step."""

    made: list = []

    def __init__(self, fn, pool=None):
        self.fn, self.launches = fn, {}
        _EagerGraph.made.append(fn)

    def replay(self):
        self.fn()


@pytest.fixture
def stub_graphs(monkeypatch):
    """CPU engines that hold graphs as the card's do, each an
    :class:`_EagerGraph`; the list of those made."""
    _EagerGraph.made = []
    monkeypatch.setattr(ServingEngine, "graphs", property(lambda self: True))
    monkeypatch.setattr(serving_engine, "StepGraph", _EagerGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return _EagerGraph.made


def test_each_sm_range_and_prompt_length_has_its_own_graphs(stub_graphs):
    """A new (n_bands, first SM) or prompt length needs a new prefill and
    decode graph; a seen one replays its own, and a job never captures.
    Replayed, the steps give the eager steps' tokens."""
    arch = "qwen3-0.6b"
    prompts = _tokens(4, (2, 10), get_smoke_config(arch).vocab)
    eng = _engine(arch)
    runs = [((None, 0), prompts), ((5, 0), prompts), ((5, 3), prompts), ((5, 0), prompts),
            ((None, 0), prompts[:, :8]), ((None, 0), prompts)]
    made = []
    for held, p in runs:
        if (p.shape[1], held) not in eng._graphs:
            with pytest.raises(RuntimeError, match="never captures"):
                eng._generate(p, 4, None, held)
            eng.capture(p.shape[1], held)
        got, _ = eng._generate(p, 4, None, held)
        np.testing.assert_array_equal(got, eng._generate(p, 4, None, held, eager=True)[0])
        made.append(len(stub_graphs))
    assert made == [2, 4, 6, 6, 8, 8]
    assert set(eng._graphs) == {(8, (None, 0)), (10, (5, 0)), (10, (5, 3)), (10, (None, 0))}
    eng.capture(10, (5, 3))   # held already: nothing captured
    assert len(stub_graphs) == 8
    eng.release_graphs()
    eng.generate(prompts, 4)  # not admitted: the first job captures, as jit compiles
    assert len(stub_graphs) == 10 and set(eng._graphs) == {(10, (None, 0))}


def _spec(name, seq_len=8):
    return ServingTaskSpec(name=name, arch_id="qwen3-0.6b", period_ms=400.0, deadline_ms=400.0,
                           batch=2, seq_len=seq_len, new_tokens=2, roofline_step_s=0.004,
                           dominant="memory_s")


def test_a_rebalance_captures_at_the_boundary_and_jobs_never_capture(stub_graphs):
    """Admission captures the granted SMs' steps; another engine's
    departure moves this service's SMs and captures there at once, drops
    the old range's graphs, and the service's jobs capture nothing.  An
    allocation changed behind the engines' backs makes a job raise until
    ``rt_regraph``."""
    arch = "qwen3-0.6b"
    prompts = _tokens(5, (2, 8), get_smoke_config(arch).vocab)
    ac = AdmissionController(gn_total=8)
    first, svc_engine = _engine(arch), _engine(arch)
    assert first.rt_register(ac, _spec("first")).admitted
    assert svc_engine.rt_register(ac, _spec("svc")).admitted
    held = svc_engine.sm_range
    assert held[1] > 0 and set(svc_engine._graphs) == {(8, held)}
    svc = svc_engine.rt_service(_spec("svc"), prompts)
    made = len(stub_graphs)
    svc.run_job()
    assert len(stub_graphs) == made

    assert first.rt_deregister()
    moved = svc_engine.sm_range
    assert moved[1] == 0 and moved != held
    assert set(svc_engine._graphs) == {(8, moved)} and len(stub_graphs) == made + 2
    assert not first._graphs and first._pool is None   # a new capture gets a new pool
    svc.run_job()
    got, _ = svc_engine.generate(prompts, 2)
    assert len(stub_graphs) == made + 2
    np.testing.assert_array_equal(got, _engine(arch)._generate(prompts, 2, None, moved,
                                                              eager=True)[0])

    ac.remove("svc")   # behind the engine's back: its SMs are now unheld
    assert ac.admit(serving_task_to_rt(_spec("other"))).admitted
    assert ac.admit(serving_task_to_rt(_spec("svc"))).admitted
    assert svc_engine.sm_range != moved
    with pytest.raises(RuntimeError, match="never captures"):
        svc.run_job()
    svc_engine.rt_regraph()
    assert set(svc_engine._graphs) == {(8, svc_engine.sm_range)}
    svc.run_job()
    assert len(stub_graphs) == made + 4


def test_graphs_refuse_topk_sampling(stub_graphs):
    """Top-k sampling is no longer refused: its steps are captured once,
    and each replay reads the job's key from the static buffer, with or
    without an explicit generator, giving the eager steps' tokens."""
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"),
                        ServeConfig(max_context=32, batch=2, sampler="topk"), device="cpu")
    prompts = _tokens(7, (2, 8), eng.cfg.vocab)
    for generator in (None, torch.Generator()):
        eng.generate(prompts, 2, generator=generator)
    assert len(stub_graphs) == 2 and set(eng._graphs) == {(8, (None, 0))}
    replayed = {key: eng.generate(prompts, 4, key=key)[0] for key in (1, 2)}
    for key, got in replayed.items():
        np.testing.assert_array_equal(
            got, eng._generate(prompts, 4, key, (None, 0), eager=True)[0])
    assert not np.array_equal(replayed[1], replayed[2]) and len(stub_graphs) == 2


# ----------------------------------------------------- the held-out script


def test_holdout_counts_exceedances_and_their_probability():
    h = _holdout()
    walls = [100.0 + i % 7 for i in range(96)] + [130.0, 100.0, 131.0, 129.0]
    responses = [w + 1.0 for w in walls]
    got = h.summarize(responses, 131.5, walls, 129.5, 1e-3)
    assert got["jobs"] == 100 and got["over_r_hat"] == [98]
    assert got["over_pwcet"] == [96, 98]
    assert got["max_r_over_r_hat"] == pytest.approx(132.0 / 131.5)
    assert got["max_wall_over_pwcet"] == pytest.approx(131.0 / 129.5)
    # P(X >= 2), X ~ Binomial(100, 1e-3)
    assert got["p_at_least_as_many_over_pwcet"] == pytest.approx(
        1 - 0.999 ** 100 - 100 * 1e-3 * 0.999 ** 99)
    assert h.binomial_tail(0, 100, 1e-3) == pytest.approx(1.0)
    assert h.binomial_tail(4, 100, 1e-3) == pytest.approx(3.6317e-6, rel=1e-4)


def test_holdout_counts_host_parts_over_the_host_bound():
    h = _holdout()
    walls = [200.0 + i % 5 for i in range(98)] + [215.0, 213.0]
    got = h.summarize_host(walls, 195.0, 19.0, 1e-3)
    assert got["host_ms"] == [w - 195.0 for w in walls]
    assert got["over_host_bound"] == [98]
    assert got["max_host_over_bound"] == pytest.approx(20.0 / 19.0)
    assert got["p_at_least_as_many_over_host_bound"] == pytest.approx(1 - 0.999 ** 100)


def test_independence_on_known_sequences():
    # alternating: every neighbour on the other side of the median
    alt = independence([1.0, 3.0] * 40)
    assert alt["lag1"] == pytest.approx(-79 / 80)
    assert (alt["runs"], alt["expected"]) == (80, 41.0)
    assert alt["z"] == pytest.approx(39 / np.sqrt(2 * 40 * 40 * 3120 / (80 * 80 * 79)))
    # blocks of one level, as calibration walls grouped by SM count lie
    blocks = independence([200.0] * 40 + [250.0] * 40)
    assert blocks["lag1"] == pytest.approx(77 / 80)
    assert blocks["runs"] == 2 and blocks["z"] < -8 and blocks["p"] < 1e-15
    # a median value is dropped; independent draws (seed 0) pass
    iid = independence(np.random.default_rng(0).normal(size=101))
    assert iid["expected"] == pytest.approx(51.0) and iid["p"] > 0.05 and abs(iid["lag1"]) < 0.25
