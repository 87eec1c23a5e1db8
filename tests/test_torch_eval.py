"""The port's ``eval`` package (sample-quality metrics and the
per-transition ELBO table) against the JAX package's ``repro.eval``.

Inputs are made with numpy from a seed and handed to both sides.  Two eps
models, each written in both frameworks: the closed-form eps of
N(mu, s^2) data on shape (2,) / (8,) (``tests/test_autoplan.py``'s
analytic model), and for image batches the elementwise mu = 0 case
eps = x * f[t], f a float32 per-timestep factor (one rounding in either
framework), on (8, 8, 3).

Tolerances:
  * ``mmd_rbf``: rtol 1e-5 against a float64 evaluation of the same
    formula, and against JAX within 1e-5 of the float64 value plus the
    JAX value's own distance from it (measured: XLA:CPU's float32 sums
    are up to 1.5e-5 relative off float64 on these inputs, the port's
    ~5e-6 at most);
  * ``frechet_proxy``, ``fid_proxy``, ``high_level_similarity``: rtol
    1e-5 (float32 features; the float64 host parts are the same numpy
    code);
  * the median of ``mmd_rbf``'s bandwidth: bitwise, odd and even counts;
  * ``image_features``: 4 float32 ulps of max|f| against a float64
    evaluation of the same features, and against JAX within that plus
    the JAX features' own distance from float64 (XLA:CPU's float32 means
    over a 32x32 image are ~8 ulps off, the port's ~1); its 4x4 resize
    alone: 4 float32 ulps of max|out| against ``jax.image.resize``;
  * ``mode_coverage``: exact;
  * ``transition_elbo_table`` with injected noise: the same +-inf pattern
    and finite entries at rtol 1e-6; ``path_nelbo`` / ``path_bpd`` to the
    same rtol; validation messages equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import eval as jeval
from repro.core import make_schedule as j_make_schedule
from repro.eval import metrics as jmetrics
from repro_torch import prng
from repro_torch import eval as teval
from repro_torch.core import make_schedule
from repro_torch.eval import metrics as tmetrics

F32_ULP = float(np.finfo(np.float32).eps)
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)


def toy_eps_pair(mu=2.0, s=0.5):
    """The closed-form eps of N(mu, s^2) data, in JAX and in PyTorch."""
    def jeps(x, t):
        a = JSCH.alpha_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return (x - jnp.sqrt(a) * mu) * jnp.sqrt(1 - a) / (1 - a + a * s * s)

    def teps(x, t):
        a = TSCH.alpha_bar.to(x.device)[t.long()].reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return ((x - torch.sqrt(a) * mu) * torch.sqrt(1 - a)
                / (1 - a + a * s * s))
    return jeps, teps


def image_eps_pair(s=0.5):
    """eps = x * f[t]: elementwise, one float32 multiply on either side."""
    a = TSCH.alpha_bar.double().numpy()
    f = (np.sqrt(1 - a) / (1 - a + a * s * s)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf.to(x.device)[t.long()].reshape(
            (-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


def _rand(seed, *shape, loc=0.0, scale=1.0):
    rs = np.random.RandomState(seed)
    return (loc + scale * rs.randn(*shape)).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _sq_dists64(a, b):
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None]
            - 2 * a @ b.T)


def _mmd64(x, y, sigmas):
    """``mmd_rbf``'s formula in float64 on the float32 inputs."""
    x = x.reshape(len(x), -1).astype(np.float64)
    y = y.reshape(len(y), -1).astype(np.float64)
    med = np.median(_sq_dists64(x[:128], x[:128]))
    total = 0.0
    for s in sigmas:
        g = 1.0 / (s * max(med, 1e-6))
        kxx, kyy, kxy = (np.exp(-g * _sq_dists64(a, b))
                         for a, b in ((x, x), (y, y), (x, y)))
        n, m = len(x), len(y)
        total += ((kxx.sum() - np.trace(kxx)) / (n * (n - 1))
                  + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
                  - 2 * kxy.mean())
    return total


def _features64(imgs, thumb):
    """``image_features`` in float64 on the float32 inputs (``thumb``: the
    4x4 resize, held on its own)."""
    x = imgs.astype(np.float64)
    return np.concatenate([
        x.mean((1, 2)), x.std((1, 2)),
        np.abs(np.diff(x, axis=1)).mean((1, 2)),
        np.abs(np.diff(x, axis=2)).mean((1, 2)),
        np.asarray(thumb, np.float64).reshape(len(x), -1)], -1)


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("n", [7, 8, 128, 129])
def test_median_is_jnp_median(n):
    """Odd counts pick the middle, even counts average the two middle
    values (``torch.median`` would return the lower one)."""
    a = _rand(n, n, 3)
    want = np.asarray(jnp.median(jnp.asarray(a)))
    got = tmetrics._median(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    if n * 3 % 2 == 0:
        assert got != torch.from_numpy(a).median().numpy()


@pytest.mark.parametrize("nx,ny,shape", [(33, 21, (2,)), (40, 40, (8,)),
                                         (150, 64, (4, 4, 3))])
def test_mmd_rbf_matches_jax(nx, ny, shape):
    """nx = 33 gives an odd count of squared distances, 40 and 150 (the
    first 128 rows) an even one."""
    x = _rand(1, nx, *shape)
    y = _rand(2, ny, *shape, loc=0.3, scale=1.2)
    for sigmas in ((1.0, 2.0, 4.0, 8.0), (0.5,)):
        want = jmetrics.mmd_rbf(jnp.asarray(x), jnp.asarray(y), sigmas)
        got = teval.mmd_rbf(torch.from_numpy(x), torch.from_numpy(y), sigmas)
        exact = _mmd64(x, y, sigmas)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, exact, rtol=1e-5)
        assert abs(got - want) <= 1e-5 * abs(exact) + abs(want - exact)


@pytest.mark.parametrize("shape", [(5, 32, 32, 3), (6, 8, 8, 3),
                                   (3, 4, 4, 1), (2, 9, 7, 2)])
def test_image_features_and_resize_match_jax(shape):
    imgs = _rand(3, *shape)
    ji, ti = _both(imgs)
    want = np.asarray(jmetrics.image_features(ji))
    got = teval.image_features(ti).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    N, C = shape[0], shape[-1]
    thumb_j = np.asarray(jax.image.resize(ji, (N, 4, 4, C), "linear"))
    exact = _features64(imgs, thumb_j)
    tol = 4 * F32_ULP * float(np.abs(exact).max())
    assert float(np.abs(got - exact).max()) <= tol
    assert float(np.abs(got - want).max()) <= tol + float(
        np.abs(want - exact).max())
    thumb_t = tmetrics._thumbnail(ti).numpy()
    assert thumb_t.shape == (N, 4, 4, C)
    tol = 4 * F32_ULP * float(np.abs(thumb_j).max())
    assert float(np.abs(thumb_t - thumb_j).max()) <= tol


def test_frechet_fid_and_similarity_match_jax():
    a = _rand(4, 24, 8, 8, 3)
    b = _rand(5, 24, 8, 8, 3, loc=0.2, scale=0.8)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    fx, fy = _rand(6, 30, 5), _rand(7, 40, 5, loc=0.5)
    np.testing.assert_allclose(teval.frechet_proxy(fx, fy),
                               jmetrics.frechet_proxy(fx, fy), rtol=1e-5)
    np.testing.assert_allclose(teval.fid_proxy(ta, tb),
                               jmetrics.fid_proxy(ja, jb), rtol=1e-5)
    np.testing.assert_allclose(teval.high_level_similarity(ta, tb),
                               jmetrics.high_level_similarity(ja, jb),
                               rtol=1e-5)
    # a set against itself: the proxy's floor and a similarity of 1
    assert abs(teval.fid_proxy(ta, ta)) < 1e-6
    np.testing.assert_allclose(teval.high_level_similarity(ta, ta), 1.0,
                               rtol=1e-6)


def test_mode_coverage_exact():
    modes = np.array([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0], [4.0, 4.0]])
    samples = _rand(8, 200, 2, scale=1.5) + modes[
        np.random.RandomState(9).randint(0, 3, 200)]
    for thresh in (0.5, 1.0, 2.0):
        want = jmetrics.mode_coverage(samples, modes, thresh)
        assert teval.mode_coverage(torch.from_numpy(samples), modes,
                                   thresh) == want
        assert teval.mode_coverage(samples, modes, thresh) == want


# ------------------------------------------------------------- ELBO table
def _assert_tables_match(t, j):
    """Finite entries at rtol 1e-6 of their mse-scaled part: row 0 holds
    the decoder's log-normalizer on top, a constant that can cancel most
    of the entry."""
    np.testing.assert_array_equal(t.grid, j.grid)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    const = 0.5 * np.log(2.0 * np.pi * j.recon_sigma ** 2)
    for name in ("trans", "prior"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == np.float64
        if name == "trans":
            a, b = a.copy(), b.copy()
            a[0, 1:] -= const
            b[0, 1:] -= const
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_array_equal(np.sign(a[np.isinf(a)]),
                                      np.sign(b[np.isinf(b)]))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)
    np.testing.assert_allclose(t.mse, j.mse, rtol=1e-6)
    assert (t.eta, t.recon_sigma, t.dims) == (j.eta, j.recon_sigma, j.dims)


@pytest.mark.parametrize("model,shape,grid,eta,rs", [
    ("toy", (16, 2), [10, 200, 700], 0.8, 0.2),
    ("toy", (8, 8), [1, 2, 50, 400, 999, 1000], 1.0, 0.1),
    ("image", (4, 8, 8, 3), [5, 60, 300, 1000], 0.5, 0.1),
])
def test_transition_elbo_table_matches_jax(model, shape, grid, eta, rs):
    jeps, teps = (toy_eps_pair() if model == "toy" else image_eps_pair())
    x0 = _rand(0, *shape, loc=2.0 if model == "toy" else 0.0, scale=0.5)
    noise = _rand(1, len(grid), *shape)
    want = jeval.transition_elbo_table(
        JSCH, jeps, jnp.asarray(x0), grid=grid, eta=eta, recon_sigma=rs,
        chunk=2, noise=jnp.asarray(noise))
    got = teval.transition_elbo_table(
        TSCH, teps, torch.from_numpy(x0), grid=grid, eta=eta,
        recon_sigma=rs, chunk=2, noise=torch.from_numpy(noise))
    _assert_tables_match(got, want)
    for taus in (grid[-1:], grid[::2], grid):
        np.testing.assert_allclose(got.path_nelbo(taus),
                                   want.path_nelbo(taus), rtol=1e-6)
        np.testing.assert_allclose(got.path_bpd(taus), want.path_bpd(taus),
                                   rtol=1e-6)
    # an injected mse skips the model on both sides
    mse = np.linspace(0.1, 1.0, len(grid))
    _assert_tables_match(
        teval.transition_elbo_table(TSCH, None, torch.from_numpy(x0),
                                    grid=grid, eta=eta, recon_sigma=rs,
                                    mse=mse),
        jeval.transition_elbo_table(JSCH, None, jnp.asarray(x0), grid=grid,
                                    eta=eta, recon_sigma=rs, mse=mse))


def test_transition_elbo_table_generator_and_full_grid():
    """Noise drawn from a key equals the same draw injected (the draw is
    JAX's: ``test_torch_draws.py``); the default grid is every timestep
    1..T."""
    _, teps = toy_eps_pair()
    x0 = torch.from_numpy(_rand(2, 4, 2, loc=2.0))
    drawn = teval.transition_elbo_table(
        TSCH, teps, x0, rng=prng.PRNGKey(3, "cpu"), grid=[50, 500])
    noise = prng.normal(prng.PRNGKey(3, "cpu"), (2, 4, 2))
    given = teval.transition_elbo_table(TSCH, teps, x0, grid=[50, 500],
                                        noise=noise)
    np.testing.assert_array_equal(drawn.trans, given.trans)
    full = teval.transition_elbo_table(TSCH, None, x0,
                                       mse=np.ones(TSCH.T))
    assert full.trans.shape == (TSCH.T + 1, TSCH.T + 1)
    np.testing.assert_array_equal(full.grid, np.arange(1, TSCH.T + 1))


def _messages(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_elbo_validation_messages_match_jax():
    jeps, teps = toy_eps_pair()
    jx, tx = _both(np.zeros((4, 2), np.float32))
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    cases = [
        (dict(eta=0.0), True), (dict(recon_sigma=0.0), True),
        (dict(grid=[0, 10]), True), (dict(grid=[10, 2000]), True),
        (dict(grid=[]), True), (dict(grid=[5, 5]), True),
        (dict(grid=[5, 10], mse=np.ones(3)), True),
        (dict(grid=[5, 10], noise=np.zeros((3, 4, 2), np.float32)), True),
        ({}, False),                       # no rng, no noise
    ]
    for kw, keyed in cases:
        jkw, tkw = dict(kw), dict(kw)
        if "noise" in kw:
            jkw["noise"] = jnp.asarray(kw["noise"])
            tkw["noise"] = torch.from_numpy(kw["noise"])
        want = _messages(lambda: jeval.transition_elbo_table(
            JSCH, jeps, jx, rng=jkey if keyed else None, **jkw))
        got = _messages(lambda: teval.transition_elbo_table(
            TSCH, teps, tx, rng=tkey if keyed else None, **tkw))
        assert got == want, kw
    tab = teval.transition_elbo_table(TSCH, teps, tx, grid=[50, 200],
                                      mse=np.ones(2))
    jtab = jeval.transition_elbo_table(JSCH, jeps, jx, grid=[50, 200],
                                       mse=np.ones(2))
    assert (_messages(lambda: tab.path_nelbo([50, 300]))
            == _messages(lambda: jtab.path_nelbo([50, 300])))


def test_eps_mse_matches_jax():
    eh, e = _rand(1, 3, 5, 8, 8, 3), _rand(2, 3, 5, 8, 8, 3)
    want = jeval.elbo.eps_mse(jnp.asarray(eh), jnp.asarray(e))
    got = teval.elbo.eps_mse(torch.from_numpy(eh), torch.from_numpy(e))
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
