"""The port's multinomial process of the paper's App. A
(``repro_torch.core.discrete``) against the JAX package's
(``repro/core/discrete.py``).

Inputs (one-hot x0 / x_t, timesteps, the x0 model's weights) are made with
numpy from a seed and handed to both sides; both draw with one threefry
key per draw.  Tolerances:
  * ``q_probs`` and ``posterior_probs``: 4 float32 ulps of scale (2**-21
    of the largest probability);
  * ``q_sample`` and ``reverse_sample``: the drawn tokens equal JAX's
    except where JAX's two largest Gumbel-perturbed logits lie within
    GUMBEL_TIE float32 ulps of max(|z|, 1) of each other (``prng.gumbel``
    and the port's ``log`` are each within 4 ulps of JAX's); every
    mismatch must be such a tie.  ``reverse_sample`` is replayed step by
    step from the port's own states (recorded by the x0 model), so a tie
    at one step does not hide the steps after it;
  * ``kl_loss``: 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro.core import discrete as jdisc
from repro_torch import core as tcore
from repro_torch import prng
from repro_torch.core import discrete as tdisc

F32_TOL = 2.0 ** -21            # 4 float32 ulps of scale
GUMBEL_TIE = 8 * 2.0 ** -23     # of max(|z|, 1)
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)


def _one_hot(seed, batch, n, K):
    idx = np.random.RandomState(seed).randint(0, K, (batch, n))
    return np.eye(K, dtype=np.float32)[idx]


def _ts(seed, batch):
    return np.random.RandomState(seed).randint(1, 1001, batch).astype(
        np.int32)


def _x0_fns(K, seed=0):
    """A fixed x0 model (softmax of a linear map of x_t and t) in both
    frameworks."""
    W = np.random.RandomState(seed).randn(K, K).astype(np.float32)

    def jfn(x, t):
        z = x @ jnp.asarray(W) + (t.astype(jnp.float32) / 1000.0)[:, None,
                                                                   None]
        return jax.nn.softmax(z, axis=-1)

    def tfn(x, t):
        z = x @ torch.from_numpy(W) + (t.float() / 1000.0)[:, None, None]
        return torch.softmax(z, dim=-1)
    return jfn, tfn


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL * max(np.abs(want).max(), 1)


def _check_ties(key, p, got_idx):
    """Every token where the port's draw differs from JAX's
    categorical(key, log(p + 1e-20)) must be a Gumbel near tie.
    Returns the number of mismatches."""
    z = np.asarray(jax.random.gumbel(key, p.shape) + jnp.log(
        jnp.asarray(p) + 1e-20))
    want = z.argmax(-1)
    bad = np.argwhere(want != got_idx)
    for pos in map(tuple, bad):
        top2 = np.sort(z[pos])[-2:]
        assert top2[1] - top2[0] <= GUMBEL_TIE * max(np.abs(top2).max(), 1), \
            (pos, top2)
    return len(bad)


@pytest.mark.parametrize("K", [2, 8, 50])
def test_q_probs_and_posterior_probs_match_jax(K):
    x0, xt = _one_hot(0, 6, 5, K), _one_hot(1, 6, 5, K)
    t = _ts(2, 6)
    s = np.maximum(t - 7, 0).astype(np.int32)
    _close(tdisc.q_probs(TSCH, torch.from_numpy(x0), torch.from_numpy(t)),
           jdisc.q_probs(JSCH, jnp.asarray(x0), jnp.asarray(t)))
    for eta in (0.0, 0.5, 1.0):
        jsig = eta * jdisc.sigma_implicit(JSCH, jnp.asarray(t),
                                          jnp.asarray(s))
        tsig = eta * tdisc.sigma_implicit(TSCH, torch.from_numpy(t),
                                          torch.from_numpy(s))
        _close(tsig, jsig)
        # x0 as probabilities (the model's output), not one-hot
        px0 = np.random.RandomState(3).dirichlet(np.ones(K), (6, 5)).astype(
            np.float32)
        got = tdisc.posterior_probs(TSCH, torch.from_numpy(xt),
                                    torch.from_numpy(px0),
                                    torch.from_numpy(t), torch.from_numpy(s),
                                    tsig)
        want = jdisc.posterior_probs(JSCH, jnp.asarray(xt), jnp.asarray(px0),
                                     jnp.asarray(t), jnp.asarray(s), jsig)
        _close(got, want)
        assert np.allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q_sample_tokens_equal_jax_except_gumbel_ties(seed):
    K = 8
    x0, t = _one_hot(seed, 64, 16, K), _ts(seed + 10, 64)
    got = tdisc.q_sample(TSCH, torch.from_numpy(x0), torch.from_numpy(t),
                         prng.PRNGKey(seed, "cpu"))
    want = np.asarray(jdisc.q_sample(JSCH, jnp.asarray(x0), jnp.asarray(t),
                                     jax.random.PRNGKey(seed)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.sum(-1), torch.ones(64, 16))
    p = np.asarray(jdisc.q_probs(JSCH, jnp.asarray(x0), jnp.asarray(t)))
    n_bad = _check_ties(jax.random.PRNGKey(seed), p, got.numpy().argmax(-1))
    assert n_bad == int((got.numpy().argmax(-1) != want.argmax(-1)).sum())


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("tau_kind", ["linear", "quadratic"])
def test_reverse_sample_matches_jax_step_by_step(eta, tau_kind):
    """K 8, batch 64, S 10: the port's chain against JAX's, each step's
    draw replayed in JAX from the port's own state; the final tokens
    equal JAX's reverse_sample when no step met a tie."""
    K, B, N, S, seed = 8, 64, 4, 10, 3
    jfn, tfn = _x0_fns(K)
    states = []

    def rec(x, t):
        states.append((x.clone(), t.clone()))
        return tfn(x, t)

    x_T = _one_hot(7, B, N, K)
    got = tdisc.reverse_sample(TSCH, rec, torch.from_numpy(x_T),
                               prng.PRNGKey(seed, "cpu"), S, eta=eta,
                               tau_kind=tau_kind)
    want = np.asarray(jdisc.reverse_sample(
        JSCH, jfn, jnp.asarray(x_T), jax.random.PRNGKey(seed), S, eta=eta,
        tau_kind=tau_kind))
    assert len(states) == S and got.shape == (B, N, K)
    tau = jcore.make_tau(1000, S, tau_kind)
    t_prev = np.concatenate([[0], tau[:-1]])[::-1]
    key = jax.random.PRNGKey(seed)
    nexts = [s for s, _ in states[1:]] + [got]
    ties = 0
    for (x, t), tp, nxt in zip(states, t_prev, nexts):
        key, k1 = jax.random.split(key)
        tc = int(t[0])
        assert t.tolist() == [tc] * B
        xj = jnp.asarray(x.numpy())
        sig = eta * jdisc.sigma_implicit(JSCH, tc, int(tp))
        p = jdisc.posterior_probs(JSCH, xj, jfn(xj, jnp.asarray(t.numpy())),
                                  tc, int(tp), sig)
        ties += _check_ties(k1, np.asarray(p), nxt.numpy().argmax(-1))
    if ties == 0:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("eta", [0.9, 0.0])
def test_kl_loss_matches_jax(eta):
    K = 8
    jfn, tfn = _x0_fns(K, seed=4)
    x0, t = _one_hot(5, 32, 6, K), _ts(6, 32)
    got = tdisc.kl_loss(TSCH, tfn, torch.from_numpy(x0), torch.from_numpy(t),
                        prng.PRNGKey(2, "cpu"), eta=eta)
    want = float(jdisc.kl_loss(JSCH, jfn, jnp.asarray(x0), jnp.asarray(t),
                               jax.random.PRNGKey(2), eta=eta))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_core_exports_discrete_like_jax():
    assert tcore.discrete is tdisc
    for name in ("q_probs", "q_sample", "sigma_implicit", "posterior_probs",
                 "reverse_sample", "kl_loss"):
        assert hasattr(tdisc, name) and hasattr(jdisc, name)
