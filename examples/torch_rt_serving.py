"""RT serving on one GPU: admission-controlled inference with the PyTorch
port, the twin of ``examples/rt_serving.py``.

  PYTHONPATH=src python examples/torch_rt_serving.py [--device cpu]

Four model services ask for admission with different periods and
deadlines; the port's AdmissionController shares the card's SMs among them
by Algorithm 2 (``gn_total`` = the card's SM count).  The chat-qwen service
registers through its serving engine, which on the card measures its
decode step and whole jobs at several SM counts and asks with the task
those measurements give (``ServingEngine.rt_register``); the other three ask
with the reference's estimated tasks.  The measured prefill and step are
printed beside chat-qwen's deadline.  Where the measured job cannot meet
that deadline on the whole card, chat-qwen asks again with a deadline of
1.5 times its measured job's R̂ alone on the whole card.  As in the
reference example, the discrete-event simulator then runs the admitted set
for 5 s and must see no miss.  Once admitted, chat-qwen's prefill and
decode matmuls run on the GN SMs it holds: the engine serves one job of
the spec's shape with qwen3-0.6b at full width (random weights), then a
few jobs at its period under the wall-clock executor, whose run the
BoundMonitor reads against the certified R̂.

Runs on the card unless asked for the CPU (``--device cpu``), where the
SM count is the H100 SXM's 132, the engine serves the small smoke
configuration, and chat-qwen's task is the reference's estimate (which
the CPU's jobs need not meet).
"""
import argparse
import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.obs import BoundMonitor
from repro_torch.runtime import (AdmissionController, ServingTaskSpec, WallClockExecutor,
                                 serving_task_to_rt, simulate)
from repro_torch.runtime.task_spec import job_response_ms
from repro_torch.sched import EventTrace
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.engine import executor_events

H100_SXM_SMS = 132
EXECUTOR_JOBS = 3

SERVICES = [
    ServingTaskSpec(
        name="chat-qwen", arch_id="qwen3-0.6b", period_ms=50.0,
        deadline_ms=40.0, batch=4, seq_len=256, new_tokens=3,
        roofline_step_s=0.002, collective_s=2e-4, dominant="compute_s",
    ),
    ServingTaskSpec(
        name="vision-internvl", arch_id="internvl2-2b", period_ms=100.0,
        deadline_ms=80.0, batch=2, seq_len=512, new_tokens=2,
        roofline_step_s=0.004, collective_s=3e-4, dominant="memory_s",
    ),
    ServingTaskSpec(
        name="audio-whisper", arch_id="whisper-base", period_ms=200.0,
        deadline_ms=150.0, batch=2, seq_len=128, new_tokens=4,
        roofline_step_s=0.001, collective_s=1e-4, dominant="compute_s",
    ),
    ServingTaskSpec(  # an aggressive latecomer that should be rejected
        name="greedy-batch", arch_id="dbrx-132b", period_ms=8.0,
        deadline_ms=6.0, batch=64, seq_len=2048, new_tokens=4,
        roofline_step_s=0.050, collective_s=1e-3, dominant="compute_s",
    ),
]


def verdict(spec, dec) -> None:
    said = "ADMITTED" if dec.admitted else f"REJECTED ({dec.reason})"
    print(f"{spec.name:18s} T={spec.period_ms:8.1f}ms D={spec.deadline_ms:8.1f}ms -> {said}")
    if dec.admitted:
        print(f"{'':18s} SM allocation now: {dec.alloc}")


def measured(engine, spec, sms: int) -> float:
    """Print chat-qwen's measurements beside its deadline; returns the
    job's R̂ alone on all ``sms`` SMs."""
    cal = engine.rt_calibration
    unbounded = dataclasses.replace(spec, deadline_ms=1e9, period_ms=2e9)
    r_all = job_response_ms(cal.task(unbounded), sms)
    row = cal.measured[sms]
    print(f"{'':18s} measured on all {sms} SMs: prefill wall {max(row['prefill_ms']):.3f} ms, "
          f"decode step device busy {max(row['device_ms']):.3f} ms, whole job wall "
          f"{max(row['job_ms']):.3f} ms; the job's R^ alone {r_all:.3f} ms beside "
          f"D={spec.deadline_ms:.1f} ms")
    return r_all


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        cfg = get_config("qwen3-0.6b")
    else:
        sms, cfg = H100_SXM_SMS, get_smoke_config("qwen3-0.6b")
    ac = AdmissionController(gn_total=sms)
    engine = ServingEngine(cfg, ServeConfig(max_context=512, batch=4), seed=0,
                           device=args.device)
    print(f"{sms} SMs to share out on {args.device}")

    qwen = SERVICES[0]
    for spec in [qwen] + SERVICES[1:]:
        if spec is qwen:
            dec = engine.rt_register(ac, spec)
        else:
            dec = ac.admit(serving_task_to_rt(spec))
        verdict(spec, dec)
        if spec is qwen and engine.rt_calibration is not None:
            measured(engine, spec, sms)
    if not engine.rt_registered and engine.rt_calibration is not None:
        unbounded = dataclasses.replace(qwen, deadline_ms=1e9, period_ms=2e9)
        deadline = math.ceil(1.5 * job_response_ms(engine.rt_calibration.task(unbounded), sms))
        qwen = dataclasses.replace(qwen, deadline_ms=float(deadline), period_ms=2.0 * deadline)
        print(f"chat-qwen asks again with D = 1.5 x its measured job's R^ alone on {sms} SMs")
        verdict(qwen, engine.rt_register(ac, qwen))
    if not engine.rt_registered:
        raise SystemExit("chat-qwen was not admitted")
    # the other services were admitted on the controller itself, which may
    # have moved chat-qwen's SMs: capture its steps where it holds them now
    engine.rt_regraph()

    sim = simulate(ac.current_taskset(), ac.current_alloc_list(), horizon=5000.0, seed=0)
    print(f"\nruntime check over 5 s: misses={sim.misses} jobs={sim.jobs}")
    assert not sim.any_miss

    gn, first = engine.sm_range
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (qwen.batch, qwen.seq_len)).astype(np.int32)
    out, stats = engine.generate(prompts, max_new_tokens=qwen.new_tokens)
    print(f"\nchat-qwen ({cfg.name}) one job on SMs {first}..{first + gn - 1} ({gn} SMs): "
          f"{out.shape[1]} tokens/slot, prefill {stats['prefill_s'] * 1e3:.1f} ms, "
          f"decode {stats['decode_s_per_tok'] * 1e3:.1f} ms/tok, D={qwen.deadline_ms:.1f} ms")
    print("sampled ids:", out[0].tolist())

    trace = EventTrace(us_per_unit=1e6, label="chat-qwen")
    executor = WallClockExecutor([engine.rt_service(qwen, prompts)], trace=trace)
    stats = executor.run((EXECUTOR_JOBS - 0.5) * qwen.period_ms / 1e3)["chat-qwen"]
    monitor = BoundMonitor().feed(executor_events(trace, {"chat-qwen": engine.rt_bound}))
    health = monitor.tasks["chat-qwen"]
    print(f"\nchat-qwen under the executor: {stats['completed']} of {stats['released']} jobs "
          f"done, worst R {health.worst_response:.1f} ms against R^ {health.bound:.1f} ms, "
          f"min headroom {health.min_headroom:.3f}, alerts {monitor.alert_counts() or 'none'}")
    print("monitor totals:", monitor.summary()["totals"])
    engine.rt_deregister()


if __name__ == "__main__":
    main()
