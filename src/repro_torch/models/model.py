"""Model: a decoder of per-layer modules (and an optional encoder), with
prefill and decode entry points.

Counterpart of ``repro.models.model.Model`` for every arch of the repo:
decoders of attention, Mamba or xLSTM mixers with MLP, MoE or no ffns
(qwen3, deepseek, olmo, phi3.5-moe, dbrx, jamba, xlstm), an optional
prefix of precomputed patch embeddings (internvl2's stub vision
frontend), and Whisper's encoder over precomputed frame embeddings, whose
output the decoder's cross-attention reads.  The JAX model scans
stacked repeats; here ``layers`` is a ``ModuleList`` with one
:class:`Block` per layer (layer ``r * len(pattern) + pos`` is pattern
position ``pos`` of repeat ``r``), and ``encoder.layers`` one per encoder
layer.  Parameter names follow the JAX tree: ``embed.w``,
``final_norm.w``, ``layers.<i>.mixer.wq``, ``encoder.layers.<i>.mixer.wq``,
... .

Entry points:
  init_params(seed) / init_caches(batch, max_len) / reset_caches(caches, cache_len)
  forward_train(tokens, extra_embeds, enc_embeds)       -> (hidden, aux_loss)
  loss(tokens, labels, extra_embeds, enc_embeds, chunk) -> scalar loss
  prefill(tokens, caches, extra_embeds, enc_embeds)     -> (last_logits, caches)
  decode_step(token, caches, cache_len)                 -> (logits, caches)

Caches are written in place: their tensors keep their addresses from the
first prefill to the last decode step, so a serving engine can allocate
them once and capture each step as a CUDA graph over them.  Every
projection runs on all SMs; the MoE aux loss is dropped in serving.

Training runs no hand kernel, as the JAX package's training reaches no
Pallas kernel: ``forward_train`` runs inside ``layers.plain_products``
(``torch.matmul`` products, JAX's attention and scan in plain PyTorch), so
autograd takes the backward.  Parameters are created without gradients;
a trainer switches them on for its own model (``requires_grad_(True)``).
With ``remat`` (the default, as JAX's ``Model.remat``) each repeat's
layers run under ``torch.utils.checkpoint``: backward recomputes them, so
one repeat's activations live at a time, as JAX's ``jax.checkpoint`` of
its scan body keeps them.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch import nn

from .blocks import (Block, block_decode, block_encode, block_prefill, block_train, init_block,
                     init_block_cache)
from .config import LayerSpec, ModelConfig
from .layers import Norm, _weight, apply_norm, init_embedding, init_norm, plain_products

__all__ = ["Model", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return device


ENC_SPEC = LayerSpec(mixer="attn", ffn="mlp")  # every encoder layer's


class Encoder(nn.Module):
    """``n_enc_layers`` blocks of attention and MLP, and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, ENC_SPEC, dtype, device)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.remat = True  # launch/steps may override
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        d, dt, dev = cfg.d_model, self.dtype, self.device
        self.embed = nn.ParameterDict({"w": _weight((cfg.vocab, d), dt, dev)})
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict({"w": _weight((cfg.vocab, d), dt, dev)})
        self.final_norm = Norm(cfg.norm, d, dt, dev)
        self.layers = nn.ModuleList(
            Block(cfg, self._spec(i), dt, dev, cross=cfg.is_encoder_decoder)
            for i in range(cfg.n_layers)
        )
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, dt, dev)

    def _spec(self, layer: int):
        return self.cfg.pattern[layer % len(self.cfg.pattern)]

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        (the JAX package's scales; not its random bits)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_embedding(self.embed["w"], gen)
        if not self.cfg.tie_embeddings:
            init_embedding(self.lm_head["w"], gen)
        init_norm(self.final_norm)
        for block in self.layers:
            init_block(block, gen)
        if self.cfg.is_encoder_decoder:
            for block in self.encoder.layers:
                init_block(block, gen)
            init_norm(self.encoder.final_norm)

    def init_caches(self, batch: int, max_len: int) -> list[dict]:
        """Per-layer caches; in an encoder-decoder each holds ``cross_kv``
        of ``enc_ctx`` encoder positions."""
        cross_ctx = self.cfg.enc_ctx if self.cfg.is_encoder_decoder else 0
        return [
            init_block_cache(self.cfg, self._spec(i), batch, max_len, self.dtype,
                             self.device, cross_ctx)
            for i in range(self.cfg.n_layers)
        ]

    @torch.no_grad()
    def reset_caches(self, caches: list[dict], cache_len: torch.Tensor) -> None:
        """Zero what a new job must not inherit from the last: every Mamba
        conv buffer and SSM state, every xLSTM state, the cross-attention
        K/V, and ``cache_len``, as the JAX engine's fresh caches are.  KV
        slots at or past a row's ``cache_len`` are masked in decode, so they
        keep their values."""
        for cache in caches:
            for key in ("ssm", "xl", "cross_kv"):
                for t in cache.get(key, ()):
                    t.zero_()
        cache_len.zero_()

    # ----------------------------------------------------------------- embed

    def _embed(self, tokens: torch.Tensor, extra_embeds=None) -> torch.Tensor:
        x = self.embed["w"][tokens.long()]
        if extra_embeds is not None:
            # stub modality frontend: precomputed patch embeddings, prepended
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def _head(self) -> torch.Tensor:
        """The [V, d_model] output embedding (the input one where tied)."""
        return (self.lm_head if not self.cfg.tie_embeddings else self.embed)["w"]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self._head().T

    # --------------------------------------------------------------- encoder

    def _encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """Whisper-style encoder over stub frame embeddings [B, S_enc, D]:
        per layer non-causal attention without rope, then the MLP; then
        ``encoder.final_norm``."""
        x = enc_embeds.to(self.dtype)
        for block in self.encoder.layers:
            x = block_encode(block, self.cfg, x)
        return apply_norm(self.encoder.final_norm, x, self.cfg.norm)

    # ----------------------------------------------------------------- train

    def forward_train(self, tokens: torch.Tensor, extra_embeds=None, enc_embeds=None):
        """Full causal forward of tokens [B, S] (after P patch embeddings
        where ``extra_embeds`` [B, P, d_model] is given; cross-attending to
        the encoded ``enc_embeds`` where the model has an encoder) ->
        (hidden [B, P + S, d_model] after the final norm, MoE aux loss).
        With ``remat`` each repeat is checkpointed (the encoder is not, as
        JAX's encoder scan is not)."""
        cfg = self.cfg
        with plain_products():
            enc_out = self._encode(enc_embeds) if enc_embeds is not None else None
            x = self._embed(tokens, extra_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        body = (functools.partial(torch.utils.checkpoint.checkpoint, self._repeat_train,
                                  use_reentrant=False, preserve_rng_state=False)
                if self.remat else self._repeat_train)
        for r in range(cfg.n_repeats):
            x, aux = body(r, x, aux, enc_out)
        return apply_norm(self.final_norm, x, cfg.norm), aux

    def _repeat_train(self, r: int, x: torch.Tensor, aux: torch.Tensor, enc_out):
        """Repeat ``r``'s layers over x, the aux loss carried through (JAX's
        ``repeat_step``).  It enters ``plain_products`` itself: a recompute
        runs in backward, outside ``forward_train``'s block (on the card on
        autograd's device thread), and must not reach a hand kernel."""
        cfg, period = self.cfg, len(self.cfg.pattern)
        with plain_products():
            for pos, spec in enumerate(cfg.pattern):
                x, a = block_train(self.layers[r * period + pos], cfg, spec, x,
                                   cfg.sliding_window, enc_out)
                aux = aux + a
        return x, aux

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, extra_embeds=None,
             enc_embeds=None, chunk: int = 256) -> torch.Tensor:
        """Mean softmax cross-entropy over the text positions, plus the aux
        loss (JAX ``Model.loss``).  The logits are taken ``chunk`` positions
        at a time (all S where ``chunk`` does not divide S) and recomputed in
        backward, so [B, S, V] never exists whole."""
        x, aux = self.forward_train(tokens, extra_embeds, enc_embeds)
        if extra_embeds is not None:
            x = x[:, extra_embeds.shape[1]:]  # loss over text positions only
        head = self._head()
        b, s, _ = x.shape
        if s % chunk != 0:
            chunk = s
        labels = labels.long()
        losses = [torch.utils.checkpoint.checkpoint(
            _chunk_loss, x[:, i:i + chunk], labels[:, i:i + chunk], head,
            use_reentrant=False, preserve_rng_state=False) for i in range(0, s, chunk)]
        return torch.stack(losses).sum() / (b * s) + aux

    # --------------------------------------------------------------- serving

    def prefill(self, tokens: torch.Tensor, caches: list[dict], extra_embeds=None,
                enc_embeds=None):
        """tokens: [B, S]; extra_embeds: [B, P, d_model] or None, prepended
        to the token embeddings (cast to the model dtype), so the caches
        fill P + S positions; enc_embeds: [B, enc_ctx, d_model] or None,
        encoded once, its cross K/V written into every layer's
        ``cross_kv``.  Returns logits of the last position [B, 1, V] and
        the caches."""
        cfg = self.cfg
        enc_out = self._encode(enc_embeds) if enc_embeds is not None else None
        x = self._embed(tokens, extra_embeds)
        for i, block in enumerate(self.layers):
            x, caches[i] = block_prefill(block, cfg, self._spec(i), x, caches[i],
                                         cfg.sliding_window, enc_out)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return self._logits(x[:, -1:]), caches

    def decode_step(self, token: torch.Tensor, caches: list[dict],
                    cache_len: torch.Tensor):
        """token: [B, 1]; cache_len: [B] valid entries per row."""
        cfg = self.cfg
        x = self._embed(token)
        for i, block in enumerate(self.layers):
            x, caches[i] = block_decode(block, cfg, self._spec(i), x, caches[i],
                                        cache_len, cfg.sliding_window)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return self._logits(x), caches


def _chunk_loss(xc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Sum over a chunk of logsumexp(logits) - logits[label], logits in
    float32 from ``xc @ head.T`` in the model dtype."""
    logits = (xc @ head.T).float()
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()
