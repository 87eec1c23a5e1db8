"""DDIM over sequences: diffusion-LM with an assigned backbone family (port
of ``examples/lm_diffusion.py``).

The paper's technique carried to the assigned architectures: train a
diffusion-LM (smollm-family dense trunk by default; moe, the rwkv6 ssm
and the Mamba2 hybrid trunks too) on the synthetic Markov-chain corpus,
then sample token sequences with DDPM (S=T) vs the accelerated DDIM
(S=10..50) and score bigram validity against the chain.  Shows the
10-50x fewer-network-evals trade-off on sequence generation.  Sampling
runs ``generate``'s eager loop, as JAX's runs its ``jnp`` scan: no kernel
launches.

  PYTHONPATH=src python -m repro_torch.examples.lm_diffusion --family dense
  PYTHONPATH=src python -m repro_torch.examples.lm_diffusion --family moe
  PYTHONPATH=src python -m repro_torch.examples.lm_diffusion --device cpu
"""
from __future__ import annotations

import argparse
import time

from repro_torch import diffusion_lm as dlm
from repro_torch import prng
from repro_torch.core import SamplerConfig, make_schedule
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.common import ArchConfig
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_diffusion_train_step, warmup_cosine)

FAMS = {
    "dense": dict(family="dense", n_kv_heads=2),
    "moe": dict(family="moe", n_kv_heads=2, n_experts=4, top_k=2,
                d_ff_expert=64, n_shared_experts=1, capacity_factor=2.0),
    "ssm": dict(family="ssm", n_kv_heads=4, head_dim=32),
    "hybrid": dict(family="hybrid", n_kv_heads=4, ssm_state=16,
                   ssm_head_dim=32, attn_every=2),
}


def config(family: str, vocab: int) -> dlm.DiffusionLMConfig:
    """The example's 4-layer, d_model 128 trunk of ``family``."""
    extra = dict(FAMS[family])
    fam = extra.pop("family")
    arch = ArchConfig(name=f"dlm-{fam}", family=fam, n_layers=4,
                      d_model=128, n_heads=4, d_ff=256, vocab=vocab,
                      **extra)
    return dlm.DiffusionLMConfig(arch=arch, time_dim=64)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    T = args.T
    schedule = make_schedule("linear", T=T)
    cfg = config(args.family, args.vocab)
    data = SyntheticTokens(vocab=args.vocab, seed=0)

    def loss_fn(p, batch, rng):
        return dlm.training_loss(p, cfg, schedule, batch, rng, remat=False)

    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(100, args.steps))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    params = dlm.init_params(prng.PRNGKey(0, dev), cfg, device=dev)
    state = init_train_state(params, prng.PRNGKey(1, dev), opt)
    gen = data.batches(args.batch, args.seq, dev)
    synchronize(dev)
    t0 = time.time()
    losses = []
    for step in range(1, args.steps + 1):
        state, m = step_fn(state, next(gen))
        if step % 100 == 0 or step == 1:
            losses.append(float(m["loss"]))
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"l_eps={float(m['l_eps']):.4f} "
                  f"l_round={float(m['l_round']):.4f}", flush=True)
    synchronize(dev)
    train_s = time.time() - t0
    print(f"trained {args.steps} steps in {train_s:.0f}s")

    rows = []
    print(f"\n{'sampler':>12s} {'S':>5s} {'bigram-valid':>13s} "
          f"{'wall_s':>7s}  (chance ~{4/args.vocab:.3f})")
    for S, eta, name in [(T, 1.0, "DDPM"), (50, 0.0, "DDIM"),
                         (20, 0.0, "DDIM"), (10, 0.0, "DDIM")]:
        scfg = SamplerConfig(S=S, eta=eta)
        t0 = time.time()
        toks = dlm.generate(state.params, cfg, schedule,
                            prng.PRNGKey(2, dev), args.eval_batch,
                            args.seq, scfg, device=dev)
        synchronize(dev)
        dt = time.time() - t0
        validity = data.bigram_validity(toks.cpu().numpy())
        rows.append((name, S, validity, dt))
        print(f"{name:>12s} {S:5d} {validity:13.3f} {dt:7.2f}", flush=True)
    return {"family": args.family, "rows": rows, "losses": losses,
            "train_step_s": train_s / max(args.steps, 1)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=list(FAMS), default="dense")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
