"""Msgpack checkpoints of a model's parameters and its optimizer state, in
the JAX package's format (``repro.train.checkpoint``), so that a checkpoint
written by either package loads in the other.

A file ``step_%08d.msgpack`` holds ``{"step", "params", "opt_state"}``,
the last two each ``packb({"treedef", "leaves": [{"dtype", "shape",
"data"}, ...]})`` over the JAX tree's leaves in its flattening order, the
layers stacked per pattern position (``convert.jax_layout``); ``treedef``
is ``str`` of the JAX treedef, which loading ignores.  The codec is
``train._msgpack``, and bf16 data is read by ``torch.frombuffer``: neither
``msgpack`` nor ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch.convert import jax_layout, jax_leaves, jax_treedef

from . import _msgpack
from .optimizer import OptState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

_EXT = ".msgpack"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _slots(tree, tensors: dict) -> list[tuple[list[torch.Tensor], bool]]:
    """Each leaf of a ``jax_layout`` tree, in JAX's order, as (its tensors,
    stacked): a stacked leaf's layers one after another."""
    return [([tensors[n] for n in leaf], True) if isinstance(leaf, list)
            else ([tensors[leaf]], False) for leaf in jax_leaves(tree)]


def _record(tensors: list[torch.Tensor], stacked: bool) -> dict:
    data = b"".join(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
                    .tobytes() for t in tensors)
    shape = ([len(tensors)] if stacked else []) + list(tensors[0].shape)
    return {"dtype": _NAMES[tensors[0].dtype], "shape": shape, "data": data}


def _encode(slots: list, treedef: str) -> bytes:
    return _msgpack.packb({"treedef": treedef,
                           "leaves": [_record(ts, stacked) for ts, stacked in slots]})


def _decode_into(buf: bytes, slots: list) -> None:
    """Copy each leaf's data into its tensors (cast to their dtype, as the
    JAX package's loader casts to the ``like`` tree's)."""
    records = _msgpack.unpackb(buf)["leaves"]
    if len(records) != len(slots):
        raise ValueError(f"checkpoint has {len(records)} leaves, the model {len(slots)}")
    for meta, (dsts, stacked) in zip(records, slots):
        want = ([len(dsts)] if stacked else []) + list(dsts[0].shape)
        if list(meta["shape"]) != want:
            raise ValueError(f"checkpoint leaf of shape {meta['shape']}, the model's {want}")
        flat = torch.frombuffer(bytearray(meta["data"]), dtype=_DTYPES[meta["dtype"]])
        for dst, src in zip(dsts, flat.reshape(len(dsts), *dsts[0].shape)):
            dst.copy_(src)


def _opt_slots(tree, state: OptState) -> list:
    return _slots(tree, state.m) + _slots(tree, state.v) + [([state.step], False)]


def _layout(model) -> dict:
    return jax_layout((n for n, _ in model.named_parameters()), model.cfg)


def save_checkpoint(dirpath, step: int, params, opt_state: OptState | None = None
                    ) -> pathlib.Path:
    """Write ``params`` (a port ``Model``) and ``opt_state`` at ``step``."""
    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    tree = _layout(params)
    blob = {"step": step,
            "params": _encode(_slots(tree, dict(params.named_parameters())), jax_treedef(tree))}
    if opt_state is not None:
        blob["opt_state"] = _encode(_opt_slots(tree, opt_state), jax_treedef(tree, "OptState"))
    out = d / f"step_{step:08d}{_EXT}"
    out.write_bytes(_msgpack.packb(blob))
    return out


def load_checkpoint(path, params_like, opt_like: OptState | None = None):
    """Read a checkpoint into ``params_like`` (a port ``Model``) and, where
    given and present, ``opt_like`` (both written in place) -> (step,
    params_like, opt_like)."""
    blob = _msgpack.unpackb(pathlib.Path(path).read_bytes())
    tree = _layout(params_like)
    with torch.no_grad():
        _decode_into(blob["params"], _slots(tree, dict(params_like.named_parameters())))
        if opt_like is not None and "opt_state" in blob:
            _decode_into(blob["opt_state"], _opt_slots(tree, opt_like))
    return blob["step"], params_like, opt_like


def latest_step(dirpath) -> int | None:
    d = pathlib.Path(dirpath)
    if not d.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in d.glob(f"step_*{_EXT}"))
    return steps[-1] if steps else None
