"""Batched serving engine: prefill + decode loop with KV-cache management
and samplers, usable standalone or under an RT admission controller.

Counterpart of ``repro.serving.engine``.  Steps are timed with CUDA events
on the card and with ``perf_counter`` on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import Model, ModelConfig
from repro_torch.runtime.task_spec import serving_task_to_rt

__all__ = ["ServeConfig", "ServingEngine", "sample_greedy", "sample_topk"]


def sample_greedy(generator: Optional[torch.Generator], logits: torch.Tensor):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topk(generator: Optional[torch.Generator], logits: torch.Tensor,
                k: int = 40, temperature: float = 0.8):
    """Sample among the k largest logits at ``temperature``; logits [..., V]."""
    v, idx = torch.topk(logits.float(), k, dim=-1)
    probs = torch.softmax(v / temperature, dim=-1)
    flat = probs.reshape(-1, k)
    choice = torch.multinomial(flat, 1, generator=generator).reshape(*v.shape[:-1], 1)
    return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)


@dataclasses.dataclass
class ServeConfig:
    max_context: int = 512
    batch: int = 4
    sampler: str = "greedy"  # greedy | topk


class _StepTimer:
    """Seconds of device work between start() and stop(): CUDA events on
    the card (read after the caller's last synchronise), perf_counter on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans.append([ev, None])
        else:
            self._spans.append([time.perf_counter(), None])

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans[-1][1] = ev
        else:
            self._spans[-1][1] = time.perf_counter()

    def seconds(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self._spans]
        return [b - a for a, b in self._spans]


class ServingEngine:
    """One model, fixed batch slots, continuous decode.

    ``params`` is a state dict (e.g. from :func:`repro_torch.convert.params_from_jax`);
    without it the weights are random from ``seed``.  Optionally registers
    with an online scheduler: ``rt_register`` asks a controller (anything
    with ``admit``; clocked controllers also have ``job_boundary``) to
    admit this engine's periodic decode service, converted to an RTGPU task
    by ``repro_torch.runtime.task_spec``, and ``rt_deregister`` departs.
    """

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.serve = serve
        self._rt = None            # (controller, service name) when admitted
        self.model = Model(cfg, device=device)
        if params is None:
            self.model.init_params(seed)
        else:
            self.model.load_state_dict(params)
        self.device = self.model.device
        self._sample = sample_greedy if serve.sampler == "greedy" else sample_topk

    # ---- online-scheduler registration --------------------------------------

    def rt_register(self, controller, spec, t: float = 0.0):
        """Admit this engine as an RT service on ``controller``.  Returns
        the controller's decision; on success the engine remembers its
        registration for :meth:`rt_deregister`."""
        task = serving_task_to_rt(spec)
        if hasattr(controller, "job_boundary"):   # online ctl/broker: clocked
            dec = controller.admit(task, t=t)
        else:                                     # static wrapper front door
            dec = controller.admit(task)
        if dec.admitted:
            self._rt = (controller, spec.name)
        return dec

    def rt_deregister(self, t: float = 0.0) -> bool:
        """Depart from the scheduler (job-boundary reclamation)."""
        if self._rt is None:
            return False
        controller, name = self._rt
        self._rt = None
        if hasattr(controller, "release"):
            return controller.release(name, t=t)
        return controller.remove(name)

    @property
    def rt_registered(self) -> bool:
        return self._rt is not None

    @torch.inference_mode()
    def generate(
        self,
        prompts: np.ndarray,           # [B, S] int32
        max_new_tokens: int = 16,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[np.ndarray, dict]:
        b, s = prompts.shape
        if b != self.serve.batch:
            raise ValueError(f"batch {b} != ServeConfig.batch {self.serve.batch}")
        if s + max_new_tokens > self.serve.max_context:
            raise ValueError("prompt + new tokens exceed max_context")
        model = self.model
        caches = model.init_caches(b, self.serve.max_context)
        tokens = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)

        prefill_t = _StepTimer(self.device)
        prefill_t.start()
        logits, caches = model.prefill(tokens, caches)
        prefill_t.stop()

        out = np.zeros((b, max_new_tokens), np.int32)
        cache_len = torch.full((b,), s, dtype=torch.int32, device=self.device)
        tok = self._sample(generator, logits[:, -1, :])[:, None]
        decode_t = _StepTimer(self.device)
        for i in range(max_new_tokens):
            out[:, i] = tok[:, 0].cpu().numpy()
            decode_t.start()
            logits, caches = model.decode_step(tok, caches, cache_len)
            decode_t.stop()
            cache_len = cache_len + 1
            tok = self._sample(generator, logits[:, -1, :])[:, None]
        decode_s = decode_t.seconds()
        stats = {
            "prefill_s": prefill_t.seconds()[0],
            "decode_s_per_tok": float(np.mean(decode_s)) if decode_s else 0.0,
            "tokens": b * max_new_tokens,
        }
        return out, stats
