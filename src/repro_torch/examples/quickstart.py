"""Quickstart — the end-to-end run (port of ``examples/quickstart.py``).

Trains a diffusion eps-model from scratch on synthetic data with the DDPM
objective (paper Eq. 5, gamma=1), then samples from the SAME trained model
with the whole generalized family (paper §4) through the declarative
``repro_torch.sampling.SamplerPlan`` front door: DDIM (eta=0), eta=0.5,
DDPM (eta=1), sigma-hat, a quadratic-tau plan, a 2nd-order multistep plan
and the autotuner's DP-searched tau, at several trajectory lengths S — the
Table-1 structure.  Finally one plan drives every backend: the 'eager'
reference loop, the 'tile_resident' loop (B1, the sampler step kernel,
once per step) and the per-row 'rows' scheduler tick (B2 once per step)
agree within 1e-4.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --preset images
  PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke
  PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch import configs, prng
from repro_torch.core import make_schedule, training_loss
from repro_torch.data import GaussianMixture2D, SyntheticImages
from repro_torch.device import resolve_device, synchronize
from repro_torch.eval import fid_proxy, mmd_rbf, mode_coverage
from repro_torch.models import unet
from repro_torch.models.common import (KeyGen, dense_init,
                                       sinusoidal_time_embedding)
from repro_torch.sampling import SamplerPlan, SigmaSpec, TauSpec
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_diffusion_train_step, module_loss,
                                  warmup_cosine)

BACKEND_TOL = 1e-4     # max|delta| of tile_resident / rows against eager


# ---------------------------------------------------------- tiny MLP model
def init_mlp(rng: torch.Tensor, d_in: int = 2, width: int = 256,
             time_dim: int = 64):
    """JAX's ``init_mlp`` for the same key, on the key's device."""
    kg = KeyGen(rng)
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32,  # noqa: E731
                                  device=rng.device)
    return {
        "w1": dense_init(kg(), (d_in + time_dim, width), torch.float32),
        "b1": zeros(width),
        "w2": dense_init(kg(), (width, width), torch.float32),
        "b2": zeros(width),
        "w3": dense_init(kg(), (width, d_in), torch.float32, scale=1e-3),
    }


def mlp_eps(params, x: torch.Tensor, t: torch.Tensor, T: int,
            time_dim: int = 64) -> torch.Tensor:
    temb = sinusoidal_time_embedding(t.to(torch.float32) * (1000.0 / T),
                                     time_dim)
    h = torch.cat([x, temb], dim=-1)
    h = F.silu(h @ params["w1"] + params["b1"])
    h = F.silu(h @ params["w2"] + params["b2"])
    return h @ params["w3"]


def train_mlp(schedule, data, steps: int, device, log_every: int = 0):
    """JAX's GMM training loop (AdamW 2e-3, warm-up 100, cosine to
    ``steps``, batches of 512): returns (params, seconds a step)."""
    T = schedule.T

    def loss_fn(p, batch, rng):
        return training_loss(schedule, lambda x, t: mlp_eps(p, x, t, T),
                             batch, rng), {}

    opt = AdamWConfig(lr=2e-3, schedule=warmup_cosine(100, steps))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    state = init_train_state(init_mlp(prng.PRNGKey(0, device)),
                             prng.PRNGKey(1, device), opt)
    gen = data.batches(512, device)
    synchronize(device)
    t0 = time.time()
    for step in range(1, steps + 1):
        state, m = step_fn(state, next(gen))
        if log_every and (step % log_every == 0 or step == 1):
            print(f"step {step:4d} loss={float(m['loss']):.4f}", flush=True)
    synchronize(device)
    return state.params, (time.time() - t0) / max(steps, 1)


def _family(schedule, S):
    """The spec gallery for one step budget S (Table-1 rows + extensions)."""
    return [
        ("DDIM e=0.0", SamplerPlan.build(schedule, tau=S)),
        ("eta=0.5", SamplerPlan.build(schedule, tau=S, sigma=0.5)),
        ("DDPM e=1.0", SamplerPlan.build(schedule, tau=S, sigma=1.0)),
        ("sigma-hat", SamplerPlan.build(schedule, tau=S,
                                        sigma=SigmaSpec.ddpm(sigma_hat=True))),
        ("quad-tau", SamplerPlan.build(schedule, tau=TauSpec.quadratic(S))),
        ("AB-2", SamplerPlan.build(schedule, tau=S, order=2)),
    ]


def run_gmm(args):
    dev = resolve_device(args.device)
    T = args.T
    schedule = make_schedule("linear", T=T)
    data = GaussianMixture2D(seed=0)
    t0 = time.time()
    params, step_s = train_mlp(schedule, data, args.steps, dev,
                               log_every=200)
    print(f"trained in {time.time()-t0:.1f}s")

    eps_fn = lambda x, t: mlp_eps(params, x, t, T)  # noqa: E731
    n = args.n_samples
    ref = data.sample(prng.PRNGKey(99, dev), n)
    xT = prng.normal(prng.PRNGKey(7, dev), (n, 2))

    # autoplan gallery row: the DP-searched explicit tau at each budget
    # (the model's own ELBO + defect terms on a small candidate grid).
    # On the --smoke budget it shows the API, not the win.
    from repro_torch.autoplan import (ObjectiveConfig, build_objective,
                                      dp_search)
    ocfg = ObjectiveConfig(
        grid_size=max(24, min(2 * max(args.steps_list), 96)),
        grid_kind="quadratic", batch=128)
    with torch.no_grad():
        dp = dp_search(
            build_objective(schedule, eps_fn,
                            data.sample(prng.PRNGKey(11, dev), 128), ocfg),
            tuple(args.steps_list))

    rows = []
    print(f"\n{'sampler':>14s} {'S':>5s} {'MMD^2':>9s} {'modes':>6s} "
          f"{'precision':>9s}")
    for S in args.steps_list:
        plans = _family(schedule, S) + [
            ("DP-tau", SamplerPlan.build(
                schedule, tau=TauSpec.explicit(dp[S].taus)))]
        for name, plan in plans:
            out = plan.run(eps_fn, xT, prng.PRNGKey(3, dev))
            with torch.no_grad():
                m2 = mmd_rbf(out, ref)
            modes, prec = mode_coverage(out.cpu().numpy(), data.modes())
            rows.append((name, plan.S, m2, modes, prec))
            print(f"{name:>14s} {plan.S:5d} {m2:9.5f} {modes:6d} "
                  f"{prec:9.3f}", flush=True)

    # ONE plan drives every backend: the eager loop, the tile-resident
    # loop (B1 per step) and the per-row scheduler tick (B2 per step).
    plan = SamplerPlan.build(schedule, tau=min(args.steps_list))
    outs = {b: plan.run(eps_fn, xT[:256], backend=b)
            for b in ("eager", "tile_resident", "rows")}
    d_tile = float((outs["eager"] - outs["tile_resident"]).abs().max())
    d_rows = float((outs["eager"] - outs["rows"]).abs().max())
    print(f"\n{plan}")
    print(f"backend max|delta| vs eager: tile_resident={d_tile:.1e} "
          f"rows={d_rows:.1e}")
    if not (d_tile < BACKEND_TOL and d_rows < BACKEND_TOL):
        raise AssertionError("backend equivalence violated")
    return {"preset": "gmm", "rows": rows, "train_step_s": step_s,
            "backend_S": plan.S, "backend_delta": {"tile_resident": d_tile,
                                                   "rows": d_rows}}


def run_images(args):
    dev = resolve_device(args.device)
    T = args.T
    schedule = make_schedule("linear", T=T)
    ucfg = configs.TOY_UNET
    data = SyntheticImages(size=16, seed=0)
    model = unet.init_params(prng.PRNGKey(0, dev), ucfg, device=dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    n = sum(p.numel() for p in params.values())
    print(f"U-Net: {n/1e6:.2f}M params")

    loss_fn = module_loss(model, lambda eps_fn, batch, rng: (
        training_loss(schedule, eps_fn, batch, rng), {}))
    opt = AdamWConfig(lr=4e-4, schedule=warmup_cosine(50, args.steps))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    state = init_train_state(params, prng.PRNGKey(1, dev), opt)
    gen = data.batches(args.batch, dev)
    synchronize(dev)
    t0 = time.time()
    for step in range(1, args.steps + 1):
        state, m = step_fn(state, next(gen))
        if step % 50 == 0 or step == 1:
            print(f"step {step:4d} loss={float(m['loss']):.4f} "
                  f"({(time.time()-t0)/step:.2f}s/step)", flush=True)
    synchronize(dev)
    step_s = (time.time() - t0) / max(args.steps, 1)

    def eps_fn(x, t):
        return torch.func.functional_call(model, state.params, (x, t))

    ref = data.sample(prng.PRNGKey(99, dev), 256)
    xT = prng.normal(prng.PRNGKey(7, dev), (128, 16, 16, 3))
    rows = []
    print(f"\n{'sampler':>14s} {'S':>5s} {'FID-proxy':>10s}")
    for S in args.steps_list:
        for name, plan in [
                ("DDIM e=0.0", SamplerPlan.build(schedule, tau=S)),
                ("DDPM e=1.0", SamplerPlan.build(schedule, tau=S,
                                                 sigma=1.0))]:
            out = plan.run(eps_fn, xT, prng.PRNGKey(3, dev))
            with torch.no_grad():
                fid = fid_proxy(out, ref)
            rows.append((name, S, fid))
            print(f"{name:>14s} {S:5d} {fid:10.3f}", flush=True)
    return {"preset": "images", "rows": rows, "train_step_s": step_s,
            "n_params": n}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["gmm", "images"], default="gmm")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--n-samples", type=int, default=4000)
    ap.add_argument("--steps-list", type=int, nargs="+",
                    default=[10, 50])
    ap.add_argument("--smoke", action="store_true",
                    help="fast smoke: tiny training run + S=5 sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = 60
        args.steps_list = [5]
        args.n_samples = 512
    if args.preset == "images" and args.steps == 2000:
        args.steps = 300
    return args


def main(argv=None):
    args = parse_args(argv)
    return run_gmm(args) if args.preset == "gmm" else run_images(args)


if __name__ == "__main__":
    main()
