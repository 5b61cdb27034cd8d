#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the runs of
``chip_smoke.py``'s train phase (qwen3-100m in float32, full-width
qwen3-0.6b in bf16; 8 x 256 tokens a step, seed 0).

    python3 scripts/train_profile.py [--steps 10]

Each run twice: with ``Model.remat`` (each repeat recomputed in backward,
the default), then without.  Per run, after 3 warm-up steps: ms/step over
``--steps`` steps (CUDA events) and the host's time to issue them (no
synchronisation inside: a host time near the device time means the step
waits on the host); then,
synchronised part by part, the loss and backward and the AdamW update,
each on the device (CUDA events) and on the host (issue time); the
multi-tensor AdamW (``train.optimizer.adamw_update``) against a per-leaf
loop of the same operations, in turns (loop, multi-tensor, multi-tensor,
loop); and a profiled step (``chip_smoke._profile``): the device's busy
ms and the costliest ops.  Lines carry the card's name and power limit;
details go to ``chiprun_out/train_profile.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def loop_adamw(cfg, model, state):
    """The update of ``train.optimizer.adamw_update`` leaf by leaf, as the
    JAX package writes it: about twenty launches a parameter."""
    import torch

    from repro_torch.train.optimizer import OptState, cosine_lr

    with torch.no_grad():
        params = dict(model.named_parameters())
        grads = {n: params[n].grad for n in state.m}
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = cosine_lr(cfg, step)
        b1c = 1.0 - torch.pow(cfg.b1, step.float())
        b2c = 1.0 - torch.pow(cfg.b2, step.float())
        for name, m in state.m.items():
            p, v = params[name], state.v[name]
            g = grads[name].float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}


def events_ms(fn, n: int) -> tuple[float, float]:
    """(device ms, host issue ms) per call of fn over n calls."""
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def profile_run(name, cfg, opt_cfg, steps: int, smi: str, remat: bool = True) -> dict:
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.train import train_step
    from repro_torch.models import Model
    from repro_torch.train.optimizer import adamw_update, init_opt_state

    model = Model(cfg, device="cuda")
    model.init_params(smoke.SEED)
    model.requires_grad_(True)
    model.remat = remat
    state = {"opt": init_opt_state(model)}
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=smoke.TRAIN_SEQ,
                                    global_batch=smoke.TRAIN_BATCH, seed=smoke.SEED))
    tokens, labels = (torch.as_tensor(np.stack(a), device="cuda")
                      for a in zip(*(data.batch(i) for i in range(steps))))
    it = {"i": 0}

    def step():
        i = it["i"] % steps
        it["i"] += 1
        state["opt"], _, _ = train_step(model, opt_cfg, state["opt"], tokens[i], labels[i])

    def loss_backward():
        i = it["i"] % steps
        it["i"] += 1
        model.zero_grad(set_to_none=True)
        model.loss(tokens[i], labels[i]).backward()

    def update(fn):
        return lambda: state.__setitem__("opt", fn(opt_cfg, model, state["opt"])[0])

    for _ in range(3):
        step()
    out = {"smi": smi}
    out["step_ms"], out["step_host_ms"] = events_ms(step, steps)
    out["loss_backward_ms"], out["loss_backward_host_ms"] = events_ms(loss_backward, steps)
    for label, fn in (("loop", loop_adamw), ("foreach", adamw_update),
                      ("foreach", adamw_update), ("loop", loop_adamw)):
        dev, host = events_ms(update(fn), steps)
        out.setdefault(f"adamw_{label}_ms", []).append(dev)
        out.setdefault(f"adamw_{label}_host_ms", []).append(host)
    prof = smoke._profile(step, 1)
    out["profiled_busy_ms"] = prof["device_ms_per_step"]
    out["profiled_wall_ms"] = prof["wall_ms_per_step"]
    out["device_ops"] = prof["device_ops_per_step"]
    out["top_ops"] = prof["top"][:10]
    print(f"[train-profile] {smi}: {name}: step {out['step_ms']:.3f} ms on the device, "
          f"{out['step_host_ms']:.3f} ms to issue; loss+backward {out['loss_backward_ms']:.3f} "
          f"ms ({out['loss_backward_host_ms']:.3f} host); AdamW loop "
          f"{out['adamw_loop_ms']} ms ({out['adamw_loop_host_ms']} host), multi-tensor "
          f"{out['adamw_foreach_ms']} ms ({out['adamw_foreach_host_ms']} host); profiled step: "
          f"{out['profiled_busy_ms']:.3f} ms busy of {out['profiled_wall_ms']:.3f}, "
          f"{out['device_ops']:.0f} device ops")
    for row in out["top_ops"][:10]:
        print(f"[train-profile] {name}:   {row}")
    del model, state
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("train_profile.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as smoke

    smi = smoke.phase_device()["nvidia_smi"]
    report = {f"{name}{'' if remat else ' without remat'}":
              profile_run(f"{name}{'' if remat else ' without remat'}", cfg, opt_cfg,
                          args.steps, smi, remat)
              for name, (cfg, _, opt_cfg) in smoke.train_configs().items()
              for remat in (True, False)}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_profile.json").write_text(json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
