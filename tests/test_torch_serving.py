"""The port's serving engine and RT bridge against the JAX package (CPU)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.roofline import HBM_BW as TPU_HBM_BW
from repro.runtime import ServingTaskSpec as JSpec
from repro.runtime import serving_task_to_rt as jax_serving_task_to_rt
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import INTERLEAVE_RATIO_MAX
from repro_torch.roofline import HBM_BW
from repro_torch.runtime import ServingTaskSpec, serving_task_to_rt
from repro_torch.serving import ServeConfig, ServingEngine, sample_greedy, sample_topk

from test_torch_model import CONFIGS

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_generate_matches_jax(name):
    jcfg, tcfg = CONFIGS[name]()
    jeng = JServingEngine(jcfg, JServeConfig(max_context=64, batch=2), seed=3)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), tcfg)
    eng = ServingEngine(tcfg, ServeConfig(max_context=64, batch=2), params=state,
                        device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want, jstats = jeng.generate(prompts, max_new_tokens=8)
    got, stats = eng.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert set(stats) == set(jstats) and stats["tokens"] == jstats["tokens"] == 16
    assert stats["prefill_s"] > 0 and stats["decode_s_per_tok"] > 0


def test_generate_is_deterministic_for_a_seed():
    _, tcfg = CONFIGS["tiny"]()
    prompts = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)
    outs = [ServingEngine(tcfg, ServeConfig(max_context=32, batch=2), seed=7,
                          device="cpu").generate(prompts, 5)[0] for _ in range(2)]
    np.testing.assert_array_equal(*outs)


def test_generate_rejects_wrong_batch_and_overflow():
    _, tcfg = CONFIGS["tiny"]()
    eng = ServingEngine(tcfg, ServeConfig(max_context=16, batch=2), device="cpu")
    with pytest.raises(ValueError):
        eng.generate(np.zeros((3, 4), np.int32), 2)
    with pytest.raises(ValueError):
        eng.generate(np.zeros((2, 12), np.int32), 8)


def test_sample_greedy_is_argmax():
    logits = torch.randn(3, 50)
    np.testing.assert_array_equal(sample_greedy(None, logits).numpy(),
                                  logits.argmax(-1).numpy())


@pytest.mark.parametrize("k", [1, 5, 40])
def test_sample_topk_support_and_shape(k):
    """jax.random bits cannot be reproduced: hold support and shape only
    (the distribution: tests/test_torch_sampling.py)."""
    logits = torch.randn(4, 3, 100, generator=torch.Generator().manual_seed(0))
    top = torch.topk(logits, k, dim=-1).indices
    for key in range(20):
        got = sample_topk(key, logits, k=k)
        assert got.shape == (4, 3) and got.dtype == torch.int32
        assert bool((got[..., None].long() == top).any(-1).all())
    if k == 1:
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1).numpy())


def test_topk_sampler_engine_runs():
    _, tcfg = CONFIGS["tiny"]()
    eng = ServingEngine(tcfg, ServeConfig(max_context=32, batch=2, sampler="topk"),
                        device="cpu")
    out, _ = eng.generate(np.ones((2, 8), np.int32), 4,
                          generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 4) and ((out >= 0) & (out < tcfg.vocab)).all()


SPECS = [
    dict(name="chat", arch_id="qwen3-0.6b", period_ms=50.0, deadline_ms=40.0, batch=4,
         seq_len=256, new_tokens=3, roofline_step_s=0.002, collective_s=2e-4,
         dominant="compute_s"),
    dict(name="vision", arch_id="internvl2-2b", period_ms=100.0, deadline_ms=80.0,
         batch=2, seq_len=512, new_tokens=2, dominant="memory_s", vocab=151936),
    dict(name="audio", arch_id="whisper-base", period_ms=200.0, deadline_ms=150.0,
         batch=2, seq_len=128, new_tokens=4, collective_s=1e-4, dominant="collective_s",
         variability=0.1),
]


def _as_dict(task):
    d = dataclasses.asdict(task)
    d["gpu"] = [dataclasses.asdict(g) for g in task.gpu]
    return d


@pytest.mark.parametrize("fields", SPECS, ids=[s["name"] for s in SPECS])
def test_serving_task_to_rt_matches_jax_at_the_tpu_constant(fields):
    got = serving_task_to_rt(ServingTaskSpec(**fields), hbm_bw=TPU_HBM_BW)
    want = jax_serving_task_to_rt(JSpec(**fields))
    assert _as_dict(got) == _as_dict(want)
    assert got.utilization() == want.utilization()


def test_serving_task_to_rt_defaults_to_the_h100_bandwidth():
    fields = SPECS[1]
    got = serving_task_to_rt(ServingTaskSpec(**fields))
    want = jax_serving_task_to_rt(JSpec(**fields))
    assert HBM_BW == 3.35e12
    ratio = got.gpu[0].work_hi / want.gpu[0].work_hi
    assert ratio == pytest.approx(TPU_HBM_BW / HBM_BW)


def test_interleave_table_is_the_papers():
    from repro.core import INTERLEAVE_RATIO_MAX as jax_table

    assert dict(INTERLEAVE_RATIO_MAX) == dict(jax_table)


class _Decision:
    def __init__(self, admitted):
        self.admitted = admitted


class _OnlineController:
    """Duck-typed like repro.sched.DynamicController: clocked admit/release."""

    job_boundary = True

    def __init__(self, admit):
        self._admit, self.calls = admit, []

    def admit(self, task, t=0.0):
        self.calls.append(("admit", task.name, t))
        return _Decision(self._admit)

    def release(self, name, t=0.0):
        self.calls.append(("release", name, t))
        return True


class _StaticController:
    """Duck-typed like repro.runtime.AdmissionController: admit/remove."""

    def __init__(self):
        self.calls = []

    def admit(self, task):
        self.calls.append(("admit", task.name))
        return _Decision(True)

    def remove(self, name):
        self.calls.append(("remove", name))
        return True


def _engine():
    _, tcfg = CONFIGS["tiny"]()
    return ServingEngine(tcfg, ServeConfig(max_context=32, batch=2), device="cpu")


def test_rt_register_and_deregister_online_controller():
    eng, ctl = _engine(), _OnlineController(admit=True)
    spec = ServingTaskSpec(**SPECS[0])
    assert eng.rt_register(ctl, spec, t=2.0).admitted
    assert eng.rt_registered
    assert eng.rt_deregister(t=5.0)
    assert not eng.rt_registered and not eng.rt_deregister()
    assert ctl.calls == [("admit", "chat", 2.0), ("release", "chat", 5.0)]


def test_rt_register_rejected_leaves_engine_unregistered():
    eng, ctl = _engine(), _OnlineController(admit=False)
    assert not eng.rt_register(ctl, ServingTaskSpec(**SPECS[0])).admitted
    assert not eng.rt_registered


def test_rt_register_static_controller():
    eng, ctl = _engine(), _StaticController()
    assert eng.rt_register(ctl, ServingTaskSpec(**SPECS[2])).admitted
    assert eng.rt_deregister()
    assert ctl.calls == [("admit", "audio"), ("remove", "audio")]


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.serving, repro_torch.kernels.ops, repro_torch.convert, "
            "repro_torch.runtime, repro_torch.configs\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_line_imports_jax_or_repro():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = [REPO / "chip_smoke.py", *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], env=env, capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
