"""Zero-dependency metrics registry for the scheduling stack.

Three instrument kinds, modeled on the Prometheus client surface but
with no external dependency and fully deterministic snapshots:

  Counter     monotone float total (``inc``)
  Gauge       last-written float value (``set`` / ``inc``)
  Histogram   fixed-bucket distribution (``observe``): cumulative bucket
              counts, sum, and count — bucket edges are frozen at first
              registration, so two runs of the same workload produce the
              same snapshot structure byte for byte

Instruments are identified by ``(name, sorted label items)``; the
registry hands out one shared instance per identity, so call sites never
hold references across enable/disable cycles.

**No-op by default.**  The module-level singleton starts as a
:class:`NullRegistry` whose instruments discard every write: the
instrumented hot paths (admission, certification, the discrete-event
engine) pay one early-returned function call when observability is off,
which keeps all goldens and benchmarks byte-identical by default
(asserted in ``tests/test_obs.py`` and ``benchmarks/obs_overhead.py``).
Enable with :func:`enable` (or the ``REPRO_OBS=1`` environment variable
at import time), read with :func:`registry`, export with
``registry().snapshot()`` / ``to_json()`` / ``to_prometheus()``.

See :mod:`repro_torch.obs` for the metric-name → emitting-layer map.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "DEFAULT_RESPONSE_BUCKETS",
    "DEFAULT_STEP_WIDTH_BUCKETS",
    "registry",
    "enabled",
    "enable",
    "disable",
    "inc",
    "set_gauge",
    "observe",
    "timed",
]

_INF = math.inf

#: wall-clock control-plane latencies (milliseconds)
DEFAULT_LATENCY_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0,
)

#: model-time observed responses / widths / counts (dimensionless edges)
DEFAULT_RESPONSE_BUCKETS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
)

#: engine event-step widths (model time): most steps are sub-period
#: slivers between releases/completions, so the edges lean small — a
#: mass at 0 exposes same-timestamp cascades (see the engine's livelock
#: guard), a heavy tail means idle horizons
DEFAULT_STEP_WIDTH_BUCKETS = (
    0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone total."""

    kind = "counter"

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def export(self):
        return self.value


class Gauge:
    """Last-written value."""

    kind = "gauge"

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def export(self):
        return self.value


class Histogram:
    """Fixed-bucket distribution: cumulative counts + sum + count.

    ``edges`` are the finite upper bounds; an implicit ``+Inf`` bucket
    catches the overflow (Prometheus ``le`` semantics)."""

    kind = "histogram"

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]) -> None:
        self.edges = tuple(float(e) for e in edges)
        if any(b <= a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("histogram bucket edges must be increasing")
        self.counts = [0] * (len(self.edges) + 1)   # +Inf overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        for i, edge in enumerate(self.edges):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def export(self):
        return {
            "buckets": {
                **{repr(e): c for e, c in zip(self.edges, self.counts)},
                "+Inf": self.counts[-1],
            },
            "sum": self.sum,
            "count": self.count,
        }


class MetricsRegistry:
    """Live registry: one shared instrument per (name, labels) identity."""

    def __init__(self) -> None:
        # name -> {"kind", "help", "edges", "series": {labelkey: instrument}}
        self._families: dict[str, dict] = {}

    # ---- instrument accessors ----------------------------------------------

    def _family(self, name: str, kind: str, help: str, edges=None) -> dict:
        fam = self._families.get(name)
        if fam is None:
            fam = {"kind": kind, "help": help, "edges": edges, "series": {}}
            self._families[name] = fam
        elif fam["kind"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam['kind']}"
            )
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        fam = self._family(name, "counter", help)
        key = _label_key(labels)
        inst = fam["series"].get(key)
        if inst is None:
            inst = fam["series"][key] = Counter()
        return inst

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        fam = self._family(name, "gauge", help)
        key = _label_key(labels)
        inst = fam["series"].get(key)
        if inst is None:
            inst = fam["series"][key] = Gauge()
        return inst

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
        help: str = "",
        **labels,
    ) -> Histogram:
        fam = self._family(name, "histogram", help,
                           edges=tuple(float(b) for b in buckets))
        key = _label_key(labels)
        inst = fam["series"].get(key)
        if inst is None:
            # the family's edges are frozen at first registration so every
            # series of one histogram shares comparable buckets
            inst = fam["series"][key] = Histogram(fam["edges"])
        return inst

    # ---- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic nested dict: families and series in sorted order,
        values as plain JSON-native types."""
        out: dict = {}
        for name in sorted(self._families):
            fam = self._families[name]
            series = {}
            for key in sorted(fam["series"]):
                label_txt = ",".join(f"{k}={v}" for k, v in key)
                series[label_txt] = fam["series"][key].export()
            out[name] = {"kind": fam["kind"], "series": series}
            if fam["help"]:
                out[name]["help"] = fam["help"]
        return out

    def to_json(self) -> str:
        """Canonical JSON text of :meth:`snapshot` (sorted keys)."""
        return json.dumps(self.snapshot(), sort_keys=True, indent=1)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (families sorted by name)."""
        lines: list[str] = []

        def fmt_labels(key: tuple, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for name in sorted(self._families):
            fam = self._families[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key in sorted(fam["series"]):
                inst = fam["series"][key]
                if fam["kind"] == "histogram":
                    cum = 0
                    for edge, c in zip(inst.edges, inst.counts):
                        cum += c
                        le = 'le="%g"' % edge
                        lines.append(
                            f"{name}_bucket{fmt_labels(key, le)} {cum}"
                        )
                    cum += inst.counts[-1]
                    inf_le = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{fmt_labels(key, inf_le)} {cum}"
                    )
                    lines.append(f"{name}_sum{fmt_labels(key)} {inst.sum:g}")
                    lines.append(
                        f"{name}_count{fmt_labels(key)} {inst.count}"
                    )
                else:
                    lines.append(f"{name}{fmt_labels(key)} {inst.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        self._families.clear()
        _WRITE_CACHE.clear()

    def value(self, name: str, **labels) -> Optional[float]:
        """Convenience reader: a counter/gauge series' current value, or
        ``None`` when the series was never written."""
        fam = self._families.get(name)
        if fam is None:
            return None
        inst = fam["series"].get(_label_key(labels))
        if inst is None or isinstance(inst, Histogram):
            return None
        return inst.value


class _NullInstrument:
    """Shared write-discarding instrument (counter/gauge/histogram)."""

    kind = "null"

    __slots__ = ()
    value = 0.0
    sum = 0.0
    count = 0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def export(self):
        return 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry(MetricsRegistry):
    """The disabled singleton: every accessor returns one shared no-op
    instrument and nothing is ever recorded."""

    def counter(self, name, help="", **labels):
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", **labels):
        return _NULL_INSTRUMENT

    def histogram(self, name, buckets=DEFAULT_LATENCY_BUCKETS_MS,
                  help="", **labels):
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}


_NULL = NullRegistry()
_LIVE = MetricsRegistry()
_REGISTRY: MetricsRegistry = (
    _LIVE if os.environ.get("REPRO_OBS", "") not in ("", "0") else _NULL
)


def registry() -> MetricsRegistry:
    """The active registry (the live one, or the no-op singleton)."""
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY is _LIVE


def enable(fresh: bool = False) -> MetricsRegistry:
    """Switch metrics on (optionally resetting all prior series)."""
    global _REGISTRY
    if fresh:
        _LIVE.reset()
    _REGISTRY = _LIVE
    return _LIVE


def disable() -> None:
    """Switch metrics off (the default); recorded series are kept until
    the next ``enable(fresh=True)``."""
    global _REGISTRY
    _REGISTRY = _NULL


# ---- module-level write helpers (the instrumented-code surface) -------------
#
# Hot paths call these rather than holding instruments: when disabled each
# is one early return, so the off state costs ~nothing and never allocates.
# When enabled, resolved instruments are memoized by (name, raw kwarg
# items) — call-site kwarg order is fixed, so the hot path skips the
# label-sort/stringify of the registry accessors; the cache is cleared
# whenever the live registry resets.

_WRITE_CACHE: dict = {}


def inc(name: str, amount: float = 1.0, **labels) -> None:
    if _REGISTRY is _NULL:
        return
    key = (name, tuple(labels.items())) if labels else name
    inst = _WRITE_CACHE.get(key)
    if inst is None:
        inst = _WRITE_CACHE[key] = _REGISTRY.counter(name, **labels)
    inst.inc(amount)


def set_gauge(name: str, value: float, **labels) -> None:
    if _REGISTRY is _NULL:
        return
    key = (name, tuple(labels.items()), "g") if labels else (name, "g")
    inst = _WRITE_CACHE.get(key)
    if inst is None:
        inst = _WRITE_CACHE[key] = _REGISTRY.gauge(name, **labels)
    inst.set(value)


def observe(
    name: str,
    value: float,
    buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
    **labels,
) -> None:
    if _REGISTRY is _NULL:
        return
    key = (name, tuple(labels.items()), "h") if labels else (name, "h")
    inst = _WRITE_CACHE.get(key)
    if inst is None:
        inst = _WRITE_CACHE[key] = _REGISTRY.histogram(
            name, buckets=buckets, **labels
        )
    inst.observe(value)


class timed:
    """Context manager observing a wall-clock duration (milliseconds) into
    a latency histogram; skips ``perf_counter`` entirely when disabled."""

    __slots__ = ("name", "labels", "t0", "ms")

    def __init__(self, name: str, **labels) -> None:
        self.name = name
        self.labels = labels
        self.t0 = None
        self.ms = 0.0

    def __enter__(self) -> "timed":
        if _REGISTRY is not _NULL:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.t0 is not None:
            self.ms = (time.perf_counter() - self.t0) * 1e3
            key = ((self.name, tuple(self.labels.items()), "h")
                   if self.labels else (self.name, "h"))
            inst = _WRITE_CACHE.get(key)
            if inst is None:
                inst = _WRITE_CACHE[key] = _REGISTRY.histogram(
                    self.name, **self.labels
                )
            inst.observe(self.ms)
