"""Roofline analysis of the port: counts of one step and the three terms.

Counterpart of ``repro.roofline``.  The JAX package reads its counts from
the compiled HLO (``analyze_hlo``); the port has no HLO, so
:func:`analyze_step` counts one eager call of a step under a dispatch
mode, and :func:`roofline_report` turns a dry-run record into

  compute term    = flops_total      / PEAK_FLOPS
  memory term     = bytes_accessed   / HBM_BW
  collective term = collective_bytes / LINK_BW

all per device, as JAX's.  The HLO parser and ``collective_bytes_from_hlo``
have no counterpart: there is no HLO to read.

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, at the full 700 W power limit); a card set to a lower limit runs
below them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Iterable, Iterator, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = [
    "PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW",
    "OpStats", "analyze_step", "step_loop", "loop_outputs", "record_kernel",
    "model_flops", "roofline_report",
]

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12  # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12     # HBM3 bytes/s
# NVLink 4: 18 links of 25 GB/s each way; 450 GB/s is the per-direction
# figure (the data sheet's 900 GB/s counts both directions).  A device
# receives a collective's output bytes in one direction.
LINK_BW = 450e9

_aten = torch.ops.aten
# ops that move no data: allocations without a fill, and views that the
# dispatcher does not mark as such
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view, _aten.detach, _aten.alias,
         _aten.lift_fresh}
# products [.., M, K] @ [.., K, N]: the argument position of the right
# operand, which may be a parameter
_PRODUCTS = {_aten.mm: 1, _aten.bmm: 1, _aten.addmm: 2, _aten.baddbmm: 2}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


@dataclasses.dataclass
class OpStats:
    """Counts of one call of a step (the counterpart of ``HloStats``).

    ``flops`` and ``bytes_accessed`` are weighted by :func:`step_loop`'s
    trip weights; ``collective_bytes``/``collective_counts`` are the output
    bytes of the c10d collectives dispatch saw (none in a one-process
    step); ``temp_peak_bytes`` is the peak of live bytes in storages the
    step created; ``products`` maps (parameter name, contracted dim of the
    parameter) to the output bytes of the products that read it."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    temp_peak_bytes: int = 0
    products: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The dispatch mode of :func:`analyze_step`."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.stats = OpStats()
        self.weight = 1
        # (first, end) sequence numbers of autograd nodes of a counted loop's
        # middle step, and their weight
        self.node_weights: list[tuple[int, int, int]] = []
        self._param_names = {id(p.untyped_storage()): (name, p) for name, p in params.items()}
        self._live: dict[int, int] = {}  # id(storage) -> nbytes, for storages made here
        self._finalizers: list = []
        self._live_bytes = 0

    # ------------------------------------------------------------- storages

    def _track(self, out: torch.Tensor) -> None:
        """Count a storage the step made as live until it is freed."""
        st = out.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.stats.temp_peak_bytes = max(self.stats.temp_peak_bytes, self._live_bytes)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    # -------------------------------------------------------------- counting

    def note_product(self, w: torch.Tensor, contracted: int, out_bytes: int) -> None:
        """A product read parameter ``w`` (maybe as a view) contracting the
        view's dim ``contracted``; recorded by the parameter's own dim."""
        hit = self._param_names.get(id(w.untyped_storage()))
        if hit is None:
            return
        name, p = hit
        if tuple(w.shape) == tuple(p.shape) and w.stride() == p.stride():
            dim = contracted
        elif w.dim() == p.dim() and tuple(w.shape[-2:]) == tuple(p.shape[-2:])[::-1]:
            dim = p.dim() - 1 if contracted == p.dim() - 2 else p.dim() - 2
        else:
            return
        key = (name, dim)
        self.stats.products[key] = self.stats.products.get(key, 0) + out_bytes * self._weight()

    def _weight(self) -> int:
        node = torch._C._current_autograd_node()
        if node is None or not self.node_weights:
            return self.weight
        seq = node._sequence_nr()
        return self.weight * next((w for lo, hi, w in self.node_weights if lo <= seq < hi), 1)

    def add(self, flops: float, nbytes: float) -> None:
        w = self._weight()
        self.stats.flops += flops * w
        self.stats.bytes_accessed += nbytes * w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        packet = func._overloadpacket
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_storages]
        for t in fresh:
            self._track(t)
        if packet in _FREE:
            return out
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        self.add(flops, sum(map(_nbytes, ins)) + sum(map(_nbytes, fresh)))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            cb = sum(map(_nbytes, outs)) * self._weight()
            self.stats.collective_bytes += cb
            self.stats.collective_counts[packet.__name__] = \
                self.stats.collective_counts.get(packet.__name__, 0) + cb
        if packet in _PRODUCTS:
            b = _PRODUCTS[packet]
            self.note_product(args[b], args[b].dim() - 2, sum(map(_nbytes, outs)))
        return out


_ACTIVE: contextvars.ContextVar[Optional[_Counter]] = contextvars.ContextVar(
    "roofline_counter", default=None)


def analyze_step(fn, *args, params: Optional[Mapping[str, torch.Tensor]] = None,
                 **kwargs) -> tuple[OpStats, object]:
    """Count one call ``fn(*args, **kwargs)`` -> (OpStats, its result).

    * ``flops``: aten's formulas (``torch.utils.flop_counter``) for every
      op dispatch sees, plus each hand kernel's own count
      (:func:`record_kernel`, from the wrappers' meta branch).
    * ``bytes_accessed``: operands plus results of every op dispatch sees,
      without views and allocations; an in-place op's result, which is its
      operand, counts once.  This is the eager counterpart of JAX's
      "top-level ops after fusion": an eager step runs each op as its own
      kernel, so every op's operands and results cross device memory.
    * :func:`step_loop` weights: a loop of ``n`` steps of equal shapes
      runs three steps and counts the middle one ``n - 2`` times, forward
      and backward, exactly as the whole loop would count.
    * ``params``: named tensors whose products are recorded in
      ``OpStats.products`` (the dry run's collective rule reads them).

    On meta tensors the step costs no memory and no device; the result of
    a weighted loop is then only shapes.  Nesting raises."""
    if _ACTIVE.get() is not None:
        raise RuntimeError("analyze_step is already counting a step")
    counter = _Counter(params or {})
    token = _ACTIVE.set(counter)
    try:
        with counter:
            result = fn(*args, **kwargs)
    finally:
        _ACTIVE.reset(token)
        counter.close()
    return counter.stats, result


@contextlib.contextmanager
def step_loop(n: int) -> Iterator[Iterable[int]]:
    """A loop of ``n`` steps of equal shapes: yields the step indices to run.

    Outside :func:`analyze_step`, ``range(n)``.  Inside it, for n > 3,
    three steps (0, 1, 2): the first, the middle one counted ``n - 2``
    times, the last (the counterpart of JAX's ``known_trip_count``
    weights).  The middle step's ops count ``n - 2`` times, and so do the
    backward ops of the autograd nodes it created (they run with
    ``torch._C._current_autograd_node()`` among them, gradient
    accumulation into their inputs included), so a train step counts
    exactly what the whole loop would: the first step starts from a state
    that needs no gradient and the last one's state is unused, as in the
    whole loop.  :func:`loop_outputs` stretches the outputs to ``n``."""
    counter = _ACTIVE.get()
    if counter is None or n <= 3:
        yield range(n)
    else:
        yield _counted_steps(counter, n)


def _counted_steps(counter: "_Counter", n: int) -> Iterator[int]:
    yield 0
    lo = torch._C._autograd._get_sequence_nr()
    counter.weight *= n - 2
    try:
        yield 1
    finally:
        counter.weight //= n - 2
    counter.node_weights.append((lo, torch._C._autograd._get_sequence_nr(), n - 2))
    yield 2


def loop_outputs(outs: list, n: int) -> list:
    """The ``n`` per-step outputs of a :func:`step_loop`: ``outs`` itself,
    or for a counted loop's three steps the middle step's output in every
    middle slot (detached after the first, so its gradient flows in once,
    as each step's does)."""
    if len(outs) == n:
        return outs
    return [outs[0], outs[1]] + [outs[1].detach()] * (n - 3) + [outs[2]]


def record_kernel(flops: float, read, written, product=None) -> None:
    """Add a hand kernel's work to the active :func:`analyze_step` (a no-op
    outside one): ``flops``, the bytes of the tensors it ``read`` once and
    ``written`` once, and ``product`` = (weight, contracted dim) where it
    multiplies by a parameter."""
    counter = _ACTIVE.get()
    if counter is None:
        return
    counter.add(flops, sum(_nbytes(t) for t in read if t is not None)
                + sum(map(_nbytes, written)))
    if product is not None:
        counter.note_product(*product, sum(map(_nbytes, written)))


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (training) / 2·N·D (inference forward),
    with N = active params and D = processed tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def roofline_report(record: dict, cfg, shape) -> dict:
    """JAX's report, term for term, on the H100's constants."""
    chips = record["chips"]
    flops = float(record["flops_total"])          # per-device
    bytes_acc = float(record["bytes_accessed"])   # per-device
    coll = float(record["collective_bytes"])      # per-device

    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": (mf / (flops * chips)) if flops else None,
        "step_time_lower_bound_s": max(terms.values()),
        "mfu_upper_bound": (
            (mf / (chips * PEAK_FLOPS)) / max(max(terms.values()), 1e-12)
            if flops else None
        ),
    }
