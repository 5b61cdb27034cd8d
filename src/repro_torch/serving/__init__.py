"""Serving substrate: batched prefill/decode engine + samplers."""
from .engine import ServeConfig, ServingEngine, sample_greedy, sample_topk

__all__ = ["ServeConfig", "ServingEngine", "sample_greedy", "sample_topk"]
