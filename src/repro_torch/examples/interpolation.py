"""Interpolation in latent space (paper §5.3, Fig. 6); port of
``examples/interpolation.py``.

DDIM's deterministic generative process makes x_T a semantic latent code:
slerp between two latents produces a smooth path in sample space. DDPM's
stochastic process destroys this (same latents -> diverse outputs).

We train the 2D-GMM eps-model (fast), build ONE deterministic
``SamplerPlan`` and use it in both directions — ``plan.encode`` maps data
to latents, ``plan.run`` decodes the slerp path on 'tile_resident' (B1,
the sampler step kernel, once per step) — then report (a) path
smoothness (mean consecutive-sample distance / max) and (b) DDIM
determinism vs DDPM dispersion at fixed x_T.

  PYTHONPATH=src python -m repro_torch.examples.interpolation
  PYTHONPATH=src python -m repro_torch.examples.interpolation --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import make_schedule, slerp
from repro_torch.data import GaussianMixture2D
from repro_torch.device import resolve_device
from repro_torch.sampling import SamplerPlan

from .quickstart import mlp_eps, train_mlp  # same toy model


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    T = 1000
    schedule = make_schedule("linear", T=T)
    data = GaussianMixture2D(seed=0)
    params, step_s = train_mlp(schedule, data, args.steps, dev)
    eps_fn = lambda x, t: mlp_eps(params, x, t, T)  # noqa: E731

    # one plan, both directions: encode to latents, decode the slerp path
    plan = SamplerPlan.build(schedule, tau=args.S)
    zA = plan.encode(eps_fn, torch.tensor([[4.0, 0.0]], device=dev))
    zB = plan.encode(eps_fn, torch.tensor([[-4.0, 0.0]], device=dev))

    alphas = torch.linspace(0, 1, args.n_interp, device=dev)
    zs = slerp(zA[0], zB[0], alphas)
    decoded = plan.run(eps_fn, zs, backend="tile_resident")
    d = decoded.cpu().numpy()
    steps = np.linalg.norm(np.diff(d, axis=0), axis=-1)
    print(f"slerp path ({plan}):")
    for a, pt in zip(alphas.cpu().numpy(), d):
        print(f"  alpha={a:.2f} -> ({pt[0]:+.2f}, {pt[1]:+.2f})")
    print(f"endpoints hit: A->{d[0]} B->{d[-1]}")
    ratio = steps.max() / max(steps.mean(), 1e-9)
    print(f"smoothness: mean step {steps.mean():.3f}, max {steps.max():.3f} "
          f"(ratio {ratio:.1f})")

    # determinism (§5.2): DDIM same x_T -> identical; DDPM -> dispersed
    xT = prng.normal(prng.PRNGKey(5, dev), (1, 2)).repeat(64, 1)
    ddim50 = SamplerPlan.build(schedule, tau=50)
    ddpm50 = SamplerPlan.build(schedule, tau=50, sigma=1.0)
    dd = ddim50.run(eps_fn, xT)
    dp = ddpm50.run(eps_fn, xT, prng.PRNGKey(6, dev))
    ddim_spread = float(torch.std(dd, 0, correction=0).max())
    ddpm_spread = float(torch.std(dp, 0, correction=0).max())
    print(f"\nsame x_T, 64 runs: DDIM spread={ddim_spread:.4f}"
          f" DDPM spread={ddpm_spread:.4f}")
    return {"path": d, "decode_S": plan.S, "mean_step": float(steps.mean()),
            "max_step": float(steps.max()), "ratio": float(ratio),
            "ddim_spread": ddim_spread, "ddpm_spread": ddpm_spread,
            "train_step_s": step_s}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--S", type=int, default=50)
    ap.add_argument("--n-interp", type=int, default=11)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
