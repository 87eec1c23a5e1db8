"""Reconstruction from latent space (paper §5.4, Table 2); port of
``examples/reconstruction.py``.

DDIM is Euler integration of an ODE (paper Eq. 14): encoding x0 -> x_T by
integrating forward and decoding back must reconstruct x0, with error
shrinking as S grows. DDPM cannot do this (stochastic process).

One ``SamplerPlan`` per step budget does both directions (``plan.encode``
then ``plan.run``), including a 2nd-order multistep column that tightens
the reconstruction at equal network-eval cost.

  PYTHONPATH=src python -m repro_torch.examples.reconstruction
  PYTHONPATH=src python -m repro_torch.examples.reconstruction --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.core import make_schedule
from repro_torch.data import GaussianMixture2D
from repro_torch.device import resolve_device
from repro_torch.sampling import SamplerPlan

from .quickstart import mlp_eps, train_mlp


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    T = 1000
    schedule = make_schedule("linear", T=T)
    data = GaussianMixture2D(seed=0)
    params, step_s = train_mlp(schedule, data, args.steps, dev)
    eps_fn = lambda x, t: mlp_eps(params, x, t, T)  # noqa: E731

    test = data.sample(prng.PRNGKey(123, dev), args.n)
    print(f"{'S':>6s} {'per-dim MSE':>12s} {'AB-2 MSE':>12s}   "
          f"(paper Table 2: error falls monotonically with S)")
    rows = []
    prev = None
    for S in args.S_list:
        errs = []
        for order in (1, 2):
            plan = SamplerPlan.build(schedule, tau=S, order=order)
            z = plan.encode(eps_fn, test)
            rec = plan.run(eps_fn, z)
            errs.append(float(torch.mean((rec - test) ** 2)))
        marker = ("" if prev is None or errs[0] <= prev
                  else "  <-- NOT monotone")
        print(f"{S:6d} {errs[0]:12.6f} {errs[1]:12.6f}{marker}")
        rows.append((S, errs[0], errs[1]))
        prev = errs[0]
    return {"rows": rows, "train_step_s": step_s}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--S-list", type=int, nargs="+",
                    default=[10, 20, 50, 100, 200, 500, 1000])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
