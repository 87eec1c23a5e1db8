"""Appendix-A demo (port of ``examples/discrete_ddim.py``): the
non-Markovian MULTINOMIAL forward process for discrete data — the paper
defines it (Eq. 17-21) and leaves experiments as future work; this example
runs the full loop on a toy categorical distribution.

A small MLP f_theta(x_t, t) predicts x0 probabilities; training minimizes
the exact categorical posterior KL (tractable — Eq. 21). Sampling uses the
generalized reverse chain with eta scaling sigma* between fully stochastic
(eta=0) and the deterministic keep-or-jump limit (eta=1), on accelerated
sub-sequences tau.  No kernel runs: the chain is plain PyTorch, as JAX's
is ``jnp``.

  PYTHONPATH=src python -m repro_torch.examples.discrete_ddim
  PYTHONPATH=src python -m repro_torch.examples.discrete_ddim --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import discrete, make_schedule
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.common import (KeyGen, dense_init,
                                       sinusoidal_time_embedding)
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_diffusion_train_step, warmup_cosine)

K = 16  # categories


def target_probs(device=None) -> torch.Tensor:
    """A bimodal categorical target (float32, as JAX's)."""
    p = np.exp(-0.5 * ((np.arange(K) - 3.0) / 1.2) ** 2)
    p += 1.5 * np.exp(-0.5 * ((np.arange(K) - 11.0) / 1.0) ** 2)
    return torch.from_numpy((p / p.sum()).astype(np.float32)).to(device)


def init_model(rng: torch.Tensor, width: int = 128, time_dim: int = 32):
    """JAX's ``init_model`` for the same key, on the key's device."""
    kg = KeyGen(rng)
    return {"w1": dense_init(kg(), (K + time_dim, width), torch.float32),
            "w2": dense_init(kg(), (width, width), torch.float32),
            "w3": dense_init(kg(), (width, K), torch.float32, scale=1e-2)}


def x0_fn(params, x_t: torch.Tensor, t: torch.Tensor, T: int) -> torch.Tensor:
    temb = sinusoidal_time_embedding(t.to(torch.float32) * (1000.0 / T), 32)
    h = torch.cat([x_t, temb], dim=-1)
    h = F.silu(h @ params["w1"])
    h = F.silu(h @ params["w2"])
    return torch.softmax(h @ params["w3"], dim=-1)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    T = args.T
    schedule = make_schedule("linear", T=T)
    probs = target_probs(dev)

    def sample_data(rng, n):
        idx = prng.categorical(rng, torch.log(probs)[None].repeat(n, 1))
        return F.one_hot(idx, K).to(torch.float32)

    def loss_fn(p, batch, rng):
        k1, k2 = prng.split(rng)
        t = prng.randint(k1, (batch.shape[0],), 1, T + 1)
        loss = discrete.kl_loss(schedule, lambda x, tt: x0_fn(p, x, tt, T),
                                batch, t, k2)
        return loss, {}

    opt = AdamWConfig(lr=2e-3, schedule=warmup_cosine(100, args.steps))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    state = init_train_state(init_model(prng.PRNGKey(0, dev)),
                             prng.PRNGKey(1, dev), opt)
    synchronize(dev)
    t0 = time.time()
    kl = []
    for step in range(1, args.steps + 1):
        batch = sample_data(prng.PRNGKey(1000 + step, dev), 256)
        state, m = step_fn(state, batch)
        if step % 200 == 0 or step == 1:
            kl.append(float(m["loss"]))
            print(f"step {step:4d} KL={kl[-1]:.4f}", flush=True)
    synchronize(dev)
    step_s = (time.time() - t0) / max(args.steps, 1)

    xT = F.one_hot(prng.randint(prng.PRNGKey(5, dev), (args.n,), 0, K).long(),
                   K).to(torch.float32)
    target = probs.cpu().numpy()
    rows = []
    print(f"\n{'S':>5s} {'eta':>5s} {'TV-distance':>12s}")
    with torch.no_grad():
        for S in args.S_list:
            for eta in (0.0, 0.5, 1.0):
                out = discrete.reverse_sample(
                    schedule, lambda x, t: x0_fn(state.params, x, t, T), xT,
                    prng.PRNGKey(7, dev), S=S, eta=eta)
                emp = np.bincount(out.argmax(-1).cpu().numpy(), minlength=K)
                emp = emp / emp.sum()
                tv = 0.5 * float(np.abs(emp - target).sum())
                rows.append((S, eta, tv))
                print(f"{S:5d} {eta:5.1f} {tv:12.4f}", flush=True)
    return {"rows": rows, "kl": kl, "train_step_s": step_s}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--S-list", type=int, nargs="+", default=[10, 25, 100])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
