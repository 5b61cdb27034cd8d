"""Training substrate of the port: optimizer and checkpointing
(counterpart of ``repro.train``)."""
from .optimizer import AdamWConfig, OptState, adamw_update, cosine_lr, init_opt_state

__all__ = ["AdamWConfig", "OptState", "adamw_update", "cosine_lr", "init_opt_state"]
