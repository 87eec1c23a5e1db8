"""B3 / B4 over trees whose leaves are of several types: the plain versions
the CUDA megakernel (its ``megastep_mixed`` library) is held against on
the card, against JAX's megakernels, and the rounding sites the wrapper
hands that library.

JAX's megakernel replays the traced eps, so each value has the type JAX's
promotion gives it.  ``kernel.trunk_types`` replays that promotion on the
leaf types; it is held against the types the port's plain trunk
(``eps_forward``) actually produces, product by product, over seeded
per-leaf trees of float32, bfloat16 and float16 leaves and each state
type.  The plain B3 / B4 run against JAX's interpret-mode kernels over
seeded per-leaf trees at a float32 state (1e-4 of max|state|) and, over
bfloat16 matrices with a float32 w_in and float32 norm scales, at a
bfloat16 state (2e-2, ``test_torch_megastep_bf16.py``'s).  JAX scans the
layers, so a tree whose layers change h's type (a bfloat16 state reaching
a float32 norm scale) raises in JAX's 'exact' trunk; the port computes
it, and the card checks it against the plain version.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_mega as mega_trunks
from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import make_schedule as j_make_schedule
from repro.kernels.megastep import kernel as jk
from repro.kernels.sampler_step import ops as jops
from repro.sampling import SamplerPlan as JPlan
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels.megastep import kernel as tk
from repro_torch.kernels.sampler_step import ops as step_ops

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
TYPES = (torch.float32, torch.bfloat16, torch.float16)
BATCH, SEQ, K = 2, 64, 2
JSCH = j_make_schedule("linear", T=1000)


def _tree_types(seed: int):
    """A seeded type for each of the 14 eps-path leaves (pointer order),
    at least two types among them."""
    rs = np.random.RandomState(seed)
    while True:
        pick = [TYPES[i] for i in rs.randint(0, 3, len(tk._POINTERS))]
        if len(set(pick)) > 1:
            return dict(zip(tk._POINTERS, pick))


def _cast(tree, types, path=()):
    if isinstance(tree, dict):
        return {k: _cast(v, types, path + (k,)) for k, v in tree.items()}
    return tree.to(types[path]) if path in types else tree


def _trees(types):
    """(JAX cfg, port cfg, JAX eps weights, port eps weights) of the
    2-layer head-dim-16 trunk with each leaf of its type in ``types``."""
    jcfg, tcfg, jp, tp = mega_trunks.trunk(16)
    tw = _cast({k: tp[k] for k in tdlm.EPS_PATH}, types)
    jw = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(),
                                            JDT[t.dtype]), tw)
    return jcfg, tcfg, jw, tw


class _ProductTypes(TorchDispatchMode):
    """The dtypes of every matrix product's output, in order."""

    def __init__(self):
        super().__init__()
        self.types = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm,
                                   torch.ops.aten.addmm):
            self.types.append(out.dtype)
        return out


@pytest.mark.parametrize("state", TYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("seed", range(4))
def test_trunk_types_follow_the_plain_trunk(seed, state):
    """Every product of the plain 'exact' trunk (the time MLP, w_in; per
    layer q, k, v, the scores, p v, wo, gate, up, down; w_out) has the type
    ``trunk_types`` gives its site, and the out norm's input is h's type
    there."""
    _, tcfg, _, tw = _trees(_tree_types(seed))
    x = torch.from_numpy(mega_trunks.state(BATCH, SEQ)).to(state)
    ty = tk.trunk_types(tw, tcfg, state)
    want = [ty["launch"][n] for n in ("t1", "t2", "in")]
    for i in range(tcfg.arch.n_layers):
        row = ty["layers"][min(i, 1)]
        want += [row[n] for n in ("q", "k", "v", "qk", "pv", "wo", "g", "u",
                                  "d")]
    want.append(ty["launch"]["eps"])
    seen = {}
    real = tdlm.rms_norm

    def out_norm(h, scale, eps):
        seen["hl"] = h.dtype
        return real(h, scale, eps)
    tdlm.rms_norm = out_norm
    try:
        with _ProductTypes() as mode:
            eps = tdlm.eps_forward(
                tw, tcfg, x.reshape(BATCH, SEQ, tcfg.latent_dim),
                torch.full((BATCH,), 500, dtype=torch.int32))
    finally:
        tdlm.rms_norm = real
    assert mode.types == want
    assert seen["hl"] == ty["launch"]["hl"] and eps.dtype == want[-1]


@pytest.mark.parametrize("state", TYPES, ids=["f32", "bf16", "f16"])
def test_mixed_weights_struct_carries_leaves_sites_and_divisors(state):
    """The ctypes struct the mixed library reads: weight code 3, each
    pointer's type code, the sites in ReproMegaSite order and sqrt(D) in
    q's type per layer row; a uniform tree keeps its own library."""
    types = _tree_types(7)
    _, tcfg, _, tw = _trees(types)
    assert tk.weight_library(tw) == tk.MIXED
    assert tk.weight_library(mega_trunks.cast(tw, torch.bfloat16)) == \
        torch.bfloat16
    for impl in tk.ATTN_IMPLS:
        w = tk._weights(tw, tcfg, tk.MIXED, state, impl)
        ty = tk.trunk_types(tw, tcfg, state, impl)
        assert w.dtype == 3
        assert list(w.leaf) == [tk.KERNEL_DTYPES.index(types[p])
                                for p in tk._POINTERS]
        codes = [tk.KERNEL_DTYPES.index(t) for t in (
            [ty["launch"][n] for n in tk._GLOBAL_SITES]
            + [r[n] for r in ty["layers"] for n in tk._LAYER_SITES])]
        assert list(w.site) == codes
        D = tcfg.arch.hd()
        assert [float(d) for d in w.attn_div] == [
            float(torch.tensor(float(D), dtype=r["q"]).sqrt())
            for r in ty["layers"]]
    # 'flash' returns attention in h's type, 'exact' in q's and v's
    f, e = (tk.trunk_types(tw, tcfg, state, i)["layers"][0]
            for i in ("flash", "exact"))
    assert f["wo"] == torch.promote_types(f["h"], types[("layers", "attn",
                                                         "wo")])
    assert e["wo"] == torch.promote_types(e["pv"], types[("layers", "attn",
                                                          "wo")])


def _jax_mega(jw, jcfg, x2, state, attn_impl, rows):
    leaves, treedef = jax.tree.flatten(jw)
    jx = jnp.asarray(x2).astype(JDT[state])
    if rows:
        tabs = [JPlan.build(JSCH, tau=S).steps() for S in (10, 25)]
        ts = np.array([tabs[0]["t"][2], tabs[1]["t"][20]], np.int32)
        sc = np.array([[tab[c][k] for c in ("c_x0", "c_dir", "c_noise",
                                            "sqrt_a_t", "sqrt_1m_a_t")]
                       for tab, k in ((tabs[0], 2), (tabs[1], 20))],
                      np.float32)
        rps = x2.shape[0] // BATCH
        want = jk.megastep_rows_call(
            jx, leaves, treedef, jcfg, BATCH, SEQ,
            jops.expand_slot_coefs(jnp.asarray(sc), rps), jnp.asarray(ts),
            attn_impl=attn_impl)
        return want, (step_ops.expand_slot_coefs(torch.from_numpy(sc), rps),
                      torch.from_numpy(ts))
    tab = JPlan.build(JSCH, tau=4).steps()
    coefs = np.stack([tab[c] for c in ("c_x0", "c_dir", "c_noise",
                                       "sqrt_a_t", "sqrt_1m_a_t")],
                     1)[:K].astype(np.float32)
    ts = np.array(tab["t"][:K], np.int32)
    want = jk.megastep_call(jx, leaves, treedef, jcfg, BATCH, SEQ,
                            jnp.asarray(coefs), jnp.asarray(ts),
                            attn_impl=attn_impl)
    return want, (torch.from_numpy(coefs), torch.from_numpy(ts))


# (tree, state, B3 or B4): seeded per-leaf trees at a float32 state, and
# bfloat16 matrices over a float32 w_in and float32 norm scales at a
# bfloat16 state (h float32 from w_in on: JAX's scan takes it)
CASES = [("seed0", torch.float32, False), ("seed1", torch.float32, True),
         ("matrices", torch.bfloat16, False),
         ("matrices", torch.bfloat16, True)]


def _case_types(tree):
    if tree == "matrices":
        return {p: (torch.float32 if p[-1].endswith("norm") or p[-1] == "w_in"
                    else torch.bfloat16) for p in tk._POINTERS}
    return _tree_types(int(tree[len("seed"):]))


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
@pytest.mark.parametrize("tree,state,rows", CASES,
                         ids=[f"{t}-{str(s)[6:]}-{'B4' if r else 'B3'}"
                              for t, s, r in CASES])
def test_plain_versions_match_jax_kernels_over_mixed_trees(tree, state, rows,
                                                           attn_impl):
    jcfg, tcfg, jw, tw = _trees(_case_types(tree))
    x2 = mega_trunks.state(BATCH, SEQ)
    want, extra = _jax_mega(jw, jcfg, x2, state, attn_impl, rows)
    fn = tk.megastep_rows_call if rows else tk.megastep_call
    got = fn(torch.from_numpy(x2).to(state), tw, tcfg, BATCH, SEQ, *extra,
             attn_impl=attn_impl)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == state and tuple(got.shape) == want.shape
    tol = 1e-4 if state == torch.float32 else 2e-2
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max()
    assert math.isfinite(err)
