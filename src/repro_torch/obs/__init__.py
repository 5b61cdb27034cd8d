"""repro_torch.obs — the port's copy of ``repro.obs.metrics``.

Counters, gauges and fixed-bucket histograms with deterministic
snapshots, Prometheus text exposition and JSON dump; off by default
(``metrics.enable()`` or ``REPRO_OBS=1``).  The copied scheduler modules
emit into this registry; the metric-name map is the reference's
(``repro.obs``).  ``BoundMonitor`` (``obs/monitor.py``) is not ported yet.
"""
from .metrics import (  # noqa: F401
    MetricsRegistry,
    NullRegistry,
    disable,
    enable,
    enabled,
    registry,
)

__all__ = [
    "MetricsRegistry",
    "NullRegistry",
    "registry",
    "enabled",
    "enable",
    "disable",
]
