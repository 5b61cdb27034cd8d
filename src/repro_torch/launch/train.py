"""Training driver (counterpart of ``repro.launch.train``): a model from the
registry, trained on the synthetic token pipeline with AdamW, on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
      --steps 50 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import LayerSpec, Model, ModelConfig
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["model_100m", "train", "train_step", "main"]


def model_100m() -> ModelConfig:
    """~100M params: 12L d=768 (GPT-2-small-scale qwen3-style), float32: the
    JAX package's ``examples/train_100m.py`` config."""
    return ModelConfig(
        name="qwen3-100m", arch_type="dense", d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=8192,
        pattern=(LayerSpec("attn", "mlp"),), n_repeats=12,
        qk_norm=True, tie_embeddings=True, dtype="float32",
    )


def train_step(model: Model, opt_cfg: AdamWConfig, opt_state, tokens, labels, **extra):
    """Loss, its gradients and one AdamW update -> (opt_state, loss,
    metrics); the model's parameters must require gradients."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(tokens, labels, **extra)
    loss.backward()
    opt_state, metrics = adamw_update(opt_cfg, model, opt_state)
    return opt_state, loss.detach(), metrics


def train(
    arch: str,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    log_every: int = 10,
    device="cuda",
):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg, device=device)
    model.init_params(0)
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    opt_state = init_opt_state(model)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))

    extra = {}  # the stub frontends' inputs: zero patch or frame embeddings
    if cfg.n_patches:
        extra["extra_embeds"] = torch.zeros((batch, cfg.n_patches, cfg.d_model),
                                            dtype=torch.float32, device=model.device)
    if cfg.is_encoder_decoder:
        extra["enc_embeds"] = torch.zeros((batch, cfg.enc_ctx, cfg.d_model),
                                          dtype=torch.float32, device=model.device)

    losses = []
    t0 = time.time()
    for step, (tokens, labels) in enumerate(data):
        if step >= steps:
            break
        opt_state, loss, metrics = train_step(
            model, opt_cfg, opt_state, torch.as_tensor(tokens, device=model.device),
            torch.as_tensor(labels, device=model.device), **extra)
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d}  loss {float(loss):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"{(time.time()-t0)/(step+1):.2f}s/step"
            )
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, model, opt_state)
        print(f"checkpoint -> {ckpt_dir}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.lr, args.ckpt_dir, device=args.device)
    print(f"first-10 mean {sum(losses[:10])/10:.4f} -> "
          f"last-10 mean {sum(losses[-10:])/10:.4f}")


if __name__ == "__main__":
    main()
