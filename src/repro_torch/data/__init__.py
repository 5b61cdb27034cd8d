"""Data substrate: shard-aware synthetic token pipeline."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
