"""Step builders: train, prefill and decode steps per (config x input shape),
with their inputs and placements (counterpart of ``repro.launch.steps``).

A bundle's model is built on ``device``: the meta device for a dry run
(no memory anywhere: parameters, caches and inputs are shapes), or a real
device, whose parameters the caller fills (``model.init_params``) and
whose input tensors (zeros) it overwrites in place.  The model holds the
parameters, so a step reads them through the model; ``args[0]`` is that
same dict of tensors, kept where JAX passes ``params`` so that the
placements and the donated arguments line up with JAX's.

Activation sharding: JAX constrains the residual stream to batch over
the data axes and d_model over the model axis (sequence local: recurrent
mixers, MoE routing cumsums and flash blocks need it whole).  The port
runs one process, so the constraint changes nothing; ``_act_shard_fn``
gives the residual's spec, which the bundle records for the dry run's
collective count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.launch.train import train_step
from repro_torch.models import InputShape, Model, ModelConfig
from repro_torch.models.sharding import (axis_sizes, batch_axes, cache_specs, param_specs,
                                         to_shardings)
from repro_torch.train.optimizer import AdamWConfig, OptState, init_opt_state

__all__ = ["StepBundle", "build_bundle", "input_specs"]


def _act_shard_fn(mesh):
    """JAX's residual constraint: the spec of a [B, S, D] activation, batch
    over the data axes (or "data", or nothing, as they divide B) and
    d_model over "model" where it divides D; None for other ranks."""
    sizes = axis_sizes(mesh)

    def act_spec(shape: tuple):
        if len(shape) != 3:
            return None
        b, _, d = shape
        dcol = "model" if d % sizes["model"] == 0 else None
        return (batch_axes(sizes, b), None, dcol)

    return act_spec


@dataclasses.dataclass
class StepBundle:
    """Everything the dry run, trainer or server needs for one (cfg, shape)."""

    cfg: ModelConfig
    shape: InputShape
    mesh: Any              # a DeviceMesh
    model: Model
    step_fn: Any           # step_fn(*args)
    args: tuple            # meta or real tensors (trees of them)
    in_shardings: tuple    # DTensor placements, per tensor of args
    kind: str              # train | prefill | decode
    donate_argnums: tuple = ()  # updated in place: params/opt-state (train), caches (serve)
    specs: tuple = ()      # the specs behind in_shardings
    act_spec: Optional[tuple] = None  # the residual's spec


def _jax_caches(model: Model, batch: int, length: int) -> list:
    """``model.init_caches`` with JAX's dtypes: the Mamba conv buffer in
    float32, as JAX's ``init_caches`` makes it (the port's serving engine
    keeps it in the model dtype, as a prefill leaves it); decode promotes
    either as JAX does."""
    caches = model.init_caches(batch, length)
    for cache in caches:
        if "ssm" in cache:
            cache["ssm"] = cache["ssm"]._replace(conv=cache["ssm"].conv.float())
    return caches


def input_specs(cfg: ModelConfig, shape: InputShape, model: Model) -> dict:
    """Every model input of this shape, as zeros on ``model``'s device
    (shapes only on the meta device), with JAX's shapes and dtypes; the
    caches from ``model.init_caches`` at ``cache_len = s + n_patches``
    (``_jax_caches``)."""
    b, s = shape.global_batch, shape.seq_len
    dev, i32 = model.device, torch.int32
    f32 = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    specs: dict[str, Any] = {}
    cache_len = s + cfg.n_patches  # VLM prompts prepend patch embeddings
    if shape.kind == "train":
        specs["tokens"] = torch.zeros((b, s), dtype=i32, device=dev)
        specs["labels"] = torch.zeros((b, s), dtype=i32, device=dev)
    elif shape.kind == "prefill":
        specs["tokens"] = torch.zeros((b, s), dtype=i32, device=dev)
        specs["caches"] = _jax_caches(model, b, cache_len)
    else:  # decode: one token against a cache of seq_len
        specs["token"] = torch.zeros((b, 1), dtype=i32, device=dev)
        specs["caches"] = _jax_caches(model, b, cache_len)
        specs["cache_len"] = torch.zeros((b,), dtype=i32, device=dev)
    if cfg.n_patches:
        specs["extra_embeds"] = torch.zeros((b, cfg.n_patches, cfg.d_model), dtype=f32,
                                            device=dev)
    if cfg.is_encoder_decoder and shape.kind in ("train", "prefill"):
        specs["enc_embeds"] = torch.zeros((b, cfg.enc_ctx, cfg.d_model), dtype=f32, device=dev)
    return specs


def _extra_kw(cfg: ModelConfig, extra: tuple) -> dict:
    """The patch and frame embeddings of ``*extra``, in JAX's order."""
    names = [n for n, on in (("extra_embeds", cfg.n_patches),
                             ("enc_embeds", cfg.is_encoder_decoder)) if on]
    return dict(zip(names, extra))


def build_bundle(cfg: ModelConfig, shape: InputShape, mesh,
                 opt: Optional[AdamWConfig] = None, device="meta") -> StepBundle:
    """The step of ``shape.kind`` for ``cfg`` on ``mesh``: train
    (``launch.train.train_step``: loss, backward, AdamW), prefill
    (``Model.prefill``) or decode (``Model.decode_step``, one token against
    a ``seq_len`` cache), with its arguments and their placements."""
    model = Model(cfg, device=device)
    params = dict(model.named_parameters())
    pspecs = param_specs(model, mesh)
    specs = input_specs(cfg, shape, model)
    b = shape.global_batch
    bspec = (batch_axes(mesh, b), None)
    espec = (*bspec, None)
    extra_names = [n for n in ("extra_embeds", "enc_embeds") if n in specs]
    act_spec = _act_shard_fn(mesh)((b, shape.seq_len + cfg.n_patches, cfg.d_model))

    def bundle(step_fn, args, arg_specs, kind, donate):
        return StepBundle(cfg, shape, mesh, model, step_fn, tuple(args),
                          tuple(to_shardings(s, mesh) for s in arg_specs), kind,
                          donate_argnums=donate, specs=tuple(arg_specs), act_spec=act_spec)

    if shape.kind == "train":
        opt = opt or AdamWConfig()
        model.requires_grad_(True)
        opt_state = init_opt_state(model)

        def train_fn(params, opt_state, tokens, labels, *extra):
            opt_state, loss, metrics = train_step(model, opt, opt_state, tokens, labels,
                                                  **_extra_kw(cfg, extra))
            return params, opt_state, loss, metrics

        ospec = OptState(m={n: pspecs[n] for n in opt_state.m},
                         v={n: pspecs[n] for n in opt_state.v}, step=())
        args = [params, opt_state, specs["tokens"], specs["labels"]]
        arg_specs = [pspecs, ospec, bspec, bspec] + [espec] * len(extra_names)
        # params + optimizer state are updated in place
        return bundle(train_fn, args + [specs[n] for n in extra_names], arg_specs, "train",
                      (0, 1))

    cspecs = cache_specs(specs["caches"], cfg, mesh, b)
    if shape.kind == "prefill":

        def prefill_fn(params, tokens, caches, *extra):
            with torch.no_grad():
                logits, caches = model.prefill(tokens, caches, **_extra_kw(cfg, extra))
            return logits, caches

        args = [params, specs["tokens"], specs["caches"]] + [specs[n] for n in extra_names]
        arg_specs = [pspecs, bspec, cspecs] + [espec] * len(extra_names)
        # the caches are filled in place
        return bundle(prefill_fn, args, arg_specs, "prefill", (2,))

    # decode: serve_step, ONE new token against a seq_len cache
    def decode_fn(params, token, caches, cache_len):
        with torch.no_grad():
            return model.decode_step(token, caches, cache_len)

    args = (params, specs["token"], specs["caches"], specs["cache_len"])
    arg_specs = (pspecs, bspec, cspecs, (bspec[0],))
    return bundle(decode_fn, args, arg_specs, "decode", (2,))
