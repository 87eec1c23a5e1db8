"""The training CLI of the port (port of ``repro/launch/train.py``).

Two modes, with JAX's flags, printed lines and checkpoint files, plus
``--device`` (default ``cuda``; the tests pass ``cpu``):
  * --arch <id>   LM pretraining on the synthetic Markov-chain corpus over
                  every family (``--smoke``: the reduced config; a vlm or
                  audio model trains on JAX's stub image or frame
                  embeddings, a moe adds 0.01 x its aux loss).
  * --arch unet   The paper's own training: the U-Net eps-model on the
                  synthetic image distribution with L_simple (Eq. 5,
                  gamma = 1), EMA tracking (decay 0.999), checkpoints.
                  As in JAX, it trains ``TOY_UNET`` whatever ``--smoke``
                  says.

  PYTHONPATH=src python -m repro_torch.launch.train --arch unet --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 50 --batch 8 --seq 128

Weights start from the init of ``PRNGKey(--seed)``; it, the data, the
train keys and the noise are threefry draws, JAX's for the same seed.
Checkpoints are JAX-layout trees in the JAX package's ``.npz`` format:
``{"params", "ema"}`` for the U-Net (what ``launch.serve --arch unet
--ckpt`` serves from), ``{"params"}`` for an LM; either package restores
them.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import configs, interop, prng
from repro_torch.core import make_schedule, training_loss
from repro_torch.data import SyntheticImages, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_api, unet
from repro_torch.models.vlm import stub_embeds
from repro_torch.training import (AdamWConfig, checkpoint, ema_init,
                                  ema_update, init_train_state,
                                  make_diffusion_train_step,
                                  make_lm_train_step, module_loss,
                                  warmup_cosine)


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def _unet_tree(model: unet.UNet, params, ucfg):
    """A JAX-layout U-Net tree of a parameter dict (buffers from model)."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    sd.update(params)
    return interop.unet_params_to_jax(sd, ucfg)


def train_unet(args):
    device = resolve_device(args.device)
    ucfg = configs.TOY_UNET       # JAX's train_unet: TOY_UNET, --smoke or not
    schedule = make_schedule("linear", T=args.T)
    model = unet.init_params(prng.PRNGKey(args.seed, device), ucfg,
                             device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    print(f"U-Net params: {_n_params(params)/1e6:.2f}M  T={args.T}")

    loss_fn = module_loss(model, lambda eps_fn, batch, rng: (
        training_loss(schedule, eps_fn, batch, rng), {}))
    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=warmup_cosine(100, args.steps))
    step_fn = make_diffusion_train_step(loss_fn, opt_cfg)
    state = init_train_state(params, prng.PRNGKey(args.seed + 1, device),
                             opt_cfg)
    ema = ema_init(params)
    data = SyntheticImages(size=args.image_size, seed=args.seed)
    gen = data.batches(args.batch, device)

    def tree(p):
        return _unet_tree(model, p, ucfg)

    t0 = time.time()
    for step in range(1, args.steps + 1):
        state, metrics = step_fn(state, next(gen))
        ema = ema_update(ema, state.params, decay=0.999)
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/step:.2f}s/step)", flush=True)
        if args.ckpt_dir and step % args.ckpt_every == 0:
            checkpoint.save_step(args.ckpt_dir, step,
                                 {"params": tree(state.params),
                                  "ema": tree(ema)})
    if args.ckpt_dir:
        path = checkpoint.save_step(args.ckpt_dir, args.steps,
                                    {"params": tree(state.params),
                                     "ema": tree(ema)})
        print(f"final checkpoint: {path}")
    return state, ema


def train_lm(args):
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(args.seed, device), cfg,
                             device=device)
    print(f"{cfg.name}: {_n_params(params)/1e6:.2f}M params")
    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=warmup_cosine(20, args.steps))
    step_fn = make_lm_train_step(cfg, opt_cfg)
    state = init_train_state(params, prng.PRNGKey(args.seed + 1, device),
                             opt_cfg)
    data = SyntheticTokens(vocab=cfg.vocab, seed=args.seed)
    gen = data.batches(args.batch, args.seq, device)
    embeds = stub_embeds(cfg, args.batch, device)
    t0 = time.time()
    losses = []
    for step in range(1, args.steps + 1):
        batch = {"tokens": next(gen)}
        if embeds is not None:
            batch["embeds"] = embeds
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/step:.2f}s/step)", flush=True)
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1]}))
    if args.ckpt_dir:
        checkpoint.save_step(args.ckpt_dir, args.steps, {
            "params": interop.lm_params_to_jax(state.params, cfg)})
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="'unet' or one of " + ", ".join(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.arch == "unet":
        train_unet(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
