"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` / ``ARCH_IDS``.

Holds the archs ported so far; ROADMAP.md lists the others.
"""
from __future__ import annotations

from . import jamba_52b, qwen3_0_6b

_MODULES = {m.ARCH_ID: m for m in (qwen3_0_6b, jamba_52b)}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str):
    return _MODULES[arch_id].config()


def get_smoke_config(arch_id: str):
    return _MODULES[arch_id].smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
