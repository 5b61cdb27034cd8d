"""Serving steps captured as CUDA graphs, and the launch counters' rule
for replays.

Counterpart of the JAX engine's ``jax.jit`` of ``prefill_fn`` and
``decode_fn``: a :class:`StepGraph` runs one step on a side stream until
every lazy set-up is done (nvcc builds, the SM probe, the band tables,
the tensor-map encoder's lookup), captures it once, and replays it with
no host work per op.  What the step reads and writes between replays must
live in tensors allocated before the capture (the engine's static caches
and buffers); what it allocates inside comes from the graph's pool.

The kernel wrappers count a launch where Python calls them
(``persistent_matmul.launches``, ``flash_attention.launches``,
``selective_scan.launches``), and a replay calls none.  So the capture
records how many launches of each kernel the graph holds
(:attr:`StepGraph.launches`) and takes them back off the counters, since
a capture runs no kernel; each :meth:`StepGraph.replay` adds them.  The
warm-up's launches are real and stay counted.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.persistent_matmul import persistent_matmul
from repro_torch.kernels.selective_scan import selective_scan

__all__ = ["WARMUP", "StepGraph", "kernel_counters", "launch_counts"]

WARMUP = 2  # eager runs of a step on the side stream before its capture


def kernel_counters() -> dict[str, Callable]:
    """Each hand kernel's wrapper, which holds its ``launches`` count."""
    return {"persistent_matmul": persistent_matmul, "flash_attention": flash_attention,
            "selective_scan": selective_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


class StepGraph:
    """``fn`` captured once, replayed by :meth:`replay`.

    On the card (``graph`` None) ``fn`` first runs ``WARMUP`` times on a
    side stream, then is captured into a ``torch.cuda.CUDAGraph`` from
    ``pool`` (a ``torch.cuda.graph_pool_handle()`` the engine's graphs
    share: they replay one at a time on one stream, and hold no tensor of
    the pool between replays).  A failed capture raises.  A ``graph``
    given stands in for the CUDA graph: ``fn`` then runs once, uncaptured,
    where the capture would be."""

    def __init__(self, fn: Callable[[], None], pool=None, graph=None):
        capture = contextlib.nullcontext()
        if graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(graph, pool=pool)
        before = launch_counts()
        try:
            with capture:
                fn()
            after = launch_counts()
        finally:
            for name, fn_ in kernel_counters().items():
                fn_.launches = before[name]
        self.graph = graph
        self.launches = {name: after[name] - before[name] for name in before}
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for name, fn in kernel_counters().items():
            fn.launches += self.launches[name]
