"""repro_torch.obs — the port's copies of ``repro.obs.metrics``,
``repro.obs.monitor`` and ``repro.obs.report``.

Counters, gauges and fixed-bucket histograms with deterministic
snapshots, Prometheus text exposition and JSON dump; off by default
(``metrics.enable()`` or ``REPRO_OBS=1``).  The copied scheduler modules
emit into this registry; the metric-name map is the reference's
(``repro.obs``).  ``BoundMonitor`` (``obs/monitor.py``) checks each
completed job's observed response against its certified bound and raises
``bound_violation`` / ``deadline_miss`` alerts; ``obs/report.py`` prints a
trace's timeline and the monitor's summary.
"""
from .metrics import (  # noqa: F401
    MetricsRegistry,
    NullRegistry,
    disable,
    enable,
    enabled,
    registry,
)
from .monitor import Alert, BoundMonitor, make_readmit_callback  # noqa: F401

__all__ = [
    "MetricsRegistry",
    "NullRegistry",
    "registry",
    "enabled",
    "enable",
    "disable",
    "Alert",
    "BoundMonitor",
    "make_readmit_callback",
]
