"""The port's optimizers (``repro_torch.training.optim``) against the JAX
package's, fed the same parameters and gradients (numpy, from a seed).

Every leaf of the new parameters and of the optimizer state is held to
ULPS = 4 float32 ulps of that leaf's max|value| (one ulp comes from
float32 pow / sqrt / rsqrt / cos, where torch's and XLA's CPU code differ;
the arithmetic around them is the same op sequence).  ``global_norm`` sums
the leaves in JAX's order (sorted keys) and is held to the same 4 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.training import optim as jopt
from repro_torch.training import optim as topt

ULPS = 4
F32_EPS = float(np.finfo(np.float32).eps)


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    shapes = {"b": {"w": (6, 5), "bias": (5,)}, "a": (3, 4, 7),
              "norm": (7,), "emb": (9, 4)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rs.randn(*s)).astype(np.float32)
    return make(shapes)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, ulps=ULPS):
    def check(g, w, path=""):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                check(g[k], w[k], path + "/" + k)
            return
        w = np.asarray(w)
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        tol = ulps * F32_EPS * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.astype(np.float64) - w).max()) <= tol, path
    check(got, want)


ADAMW = {
    "clip": dict(lr=1e-2),
    "no-clip-decay": dict(lr=1e-2, clip_norm=0.0, weight_decay=0.1),
    "schedule": dict(lr=3e-3, clip_norm=0.5),
}


@pytest.mark.parametrize("case", list(ADAMW))
def test_adamw_matches_jax(case):
    kw = dict(ADAMW[case])
    jkw, tkw = dict(kw), dict(kw)
    if case == "schedule":
        jkw["schedule"] = jopt.warmup_cosine(2, 6)
        tkw["schedule"] = topt.warmup_cosine(2, 6)
    jcfg, tcfg = jopt.AdamWConfig(**jkw), topt.AdamWConfig(**tkw)
    p = _tree(0)
    jp, tp = _j(p), _t(p)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(4):
        g = _tree(10 + step, scale=3.0)
        jp, js, jm = jopt.adamw_update(jcfg, _j(g), js, jp)
        tp, ts, tm = topt.adamw_update(tcfg, _t(g), ts, tp)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts.mu, js.mu)
        _assert_tree_close(ts.nu, js.nu)
        assert int(ts.step) == int(js.step) == step + 1
        _assert_tree_close({"n": tm["grad_norm"]}, {"n": jm["grad_norm"]})
        _assert_tree_close({"lr": torch.as_tensor(tm["lr"])},
                           {"lr": np.float32(jm["lr"])})


@pytest.mark.parametrize("decay", [0.0, 0.1], ids=str)
def test_adafactor_matches_jax(decay):
    """Factored (2-D and 3-D leaves) and unfactored (1-D) moments."""
    jcfg = jopt.AdafactorConfig(lr=1e-2, weight_decay=decay)
    tcfg = topt.AdafactorConfig(lr=1e-2, weight_decay=decay)
    p = _tree(1)
    jp, tp = _j(p), _t(p)
    js, ts = jopt.adafactor_init(jp), topt.adafactor_init(tp)
    _assert_tree_close(ts.vr, js.vr)
    _assert_tree_close(ts.vc, js.vc)
    _assert_tree_close(ts.v, js.v)
    for step in range(3):
        g = _tree(20 + step, scale=0.5)
        jp, js, jm = jopt.adafactor_update(jcfg, _j(g), js, jp)
        tp, ts, tm = topt.adafactor_update(tcfg, _t(g), ts, tp)
        _assert_tree_close(tp, jp)
        for name in ("vr", "vc", "v"):
            _assert_tree_close(getattr(ts, name), getattr(js, name))
        _assert_tree_close({"n": tm["grad_norm"]}, {"n": jm["grad_norm"]})


def test_ema_matches_jax():
    p, q = _tree(2), _tree(3)
    je, te = jopt.ema_init(_j(p)), topt.ema_init(_t(p))
    for decay in (0.999, 0.9):
        je = jopt.ema_update(je, _j(q), decay=decay)
        te = topt.ema_update(te, _t(q), decay=decay)
        _assert_tree_close(te, je, ulps=1)


def test_global_norm_and_clip_match_jax():
    g = _tree(4, scale=2.0)
    _assert_tree_close({"n": topt.global_norm(_t(g))},
                       {"n": jopt.global_norm(_j(g))})
    for max_norm in (0.5, 1e6):
        tg, tn = topt.clip_by_global_norm(_t(g), max_norm)
        jg, jn = jopt.clip_by_global_norm(_j(g), max_norm)
        _assert_tree_close(tg, jg)
    assert [tuple(x.shape) for x in topt.tree_leaves(_t(g))] == [
        x.shape for x in jax.tree.leaves(_j(g))]


@pytest.mark.parametrize("warmup,total", [(100, 300), (0, 10), (20, 20)],
                         ids=str)
def test_schedules_match_jax(warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    js = jopt.warmup_cosine(warmup, total)
    ts = topt.warmup_cosine(warmup, total)
    want = np.array([js(jnp.asarray(s)) for s in steps])
    got = np.array([float(ts(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    _assert_tree_close({"s": torch.from_numpy(got)}, {"s": want})
    assert float(topt.constant()(torch.tensor(3))) == 1.0


def _adamw_loop(cfg, grads, state, params):
    """AdamW leaf by leaf, as the JAX function writes it: the reference
    the port's foreach update must equal bitwise on the CPU."""
    if cfg.clip_norm:
        gnorm = topt.global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = topt.tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    s = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1), s)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2), s)

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p
        return p - lr * delta, m, v
    out = topt.tree_map(upd, params, grads, state.mu, state.nu)
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def _pick(out, i):
    if isinstance(out, dict):
        return {k: _pick(v, i) for k, v in out.items()}
    return out[i]


def _assert_tree_equal(a, b):
    for x, y in zip(topt.tree_leaves(a), topt.tree_leaves(b)):
        assert torch.equal(x, y)


def test_foreach_adamw_and_ema_bitwise_with_the_leaf_loop():
    """The foreach update equals the per-leaf loop bit for bit on the CPU
    (clipping, weight decay and the schedule on)."""
    cfg = topt.AdamWConfig(lr=1e-2, clip_norm=0.5, weight_decay=0.1,
                           schedule=topt.warmup_cosine(2, 6))
    tp = _t(_tree(5))
    st = topt.adamw_init(tp)
    ref_p, ref_m, ref_v = tp, st.mu, st.nu
    for step in range(4):
        g = _t(_tree(30 + step, scale=3.0))
        want = _adamw_loop(cfg, g, topt.AdamWState(st.step, ref_m, ref_v),
                           ref_p)
        tp, st, _ = topt.adamw_update(cfg, g, st, tp)
        ref_p, ref_m, ref_v = want
        _assert_tree_equal(tp, ref_p)
        _assert_tree_equal(st.mu, ref_m)
        _assert_tree_equal(st.nu, ref_v)
    e = topt.ema_update(topt.ema_init(tp), _t(_tree(9)), 0.999)
    want = topt.tree_map(lambda a, b: 0.999 * a + (1.0 - 0.999) * b, tp,
                         _t(_tree(9)))
    _assert_tree_equal(e, want)
    assert list(e) == list(tp)            # the tree keeps its key order
