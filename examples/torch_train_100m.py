"""End-to-end training of the port: a ~100M-param qwen3-family model for a
few hundred steps on synthetic bigram data (loss must drop), on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_train_100m.py --steps 200

The substrate working together: data pipeline -> model -> chunked loss ->
AdamW -> checkpoint (``examples/train_100m.py`` in the JAX package).
"""
import argparse
import tempfile

import torch

from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.train import model_100m, train_step
from repro_torch.models import Model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = model_100m()
    model = Model(cfg, device=args.device)
    model.init_params(0)
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    opt_state = init_opt_state(model)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))

    losses = []
    for step, (tokens, labels) in enumerate(data):
        if step >= args.steps:
            break
        opt_state, loss, metrics = train_step(
            model, opt_cfg, opt_state, torch.as_tensor(tokens, device=model.device),
            torch.as_tensor(labels, device=model.device))
        losses.append(float(loss))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"lr {float(metrics['lr']):.2e}")
    first = sum(losses[:10]) / min(10, len(losses))
    last = sum(losses[-10:]) / min(10, len(losses))
    print(f"\nloss: first-10 {first:.4f} -> last-10 {last:.4f}")
    assert last < first, "training failed to reduce loss"
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(args.ckpt_dir or tmp, args.steps, model)
        print(f"checkpoint saved -> {path} ({path.stat().st_size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
