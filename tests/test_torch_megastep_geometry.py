"""B3 / B4 over every geometry JAX's megakernel admits: the plain versions
the CUDA megakernel is held against on the card, against JAX's.

The CUDA kernel takes any seq_len whose sample is whole 256-wide tile rows
(64-row product tiles that straddle samples and end past the batch), any
latent and product width (tiles cut mid-way, rows that are no whole
16-byte chunks), and even head dims 2 to 256 (padded attention widths,
ragged K/V blocks).  Its plain versions (``megastep_ref`` /
``megastep_rows_ref``) take the same geometries on the CPU; these tests
hold them against JAX's at the geometries the card checks
(``chip_smoke.py`` phase 20): seq_len 32 and 96 at latent 64, 16 and 80
at latent 128, 8 and 200 at latent 256, latent 16 at 128 tokens, head dims
8, 24, 48, 80, 96, 112, 160 and 256, d_model 72 with d_ff 100.

Weights and states come from a numpy seed (1 layer, narrow widths); B3 is
one fused step, B4 one tick with a timestep and a coefficient row per
slot.  JAX's oracle is ``megastep/ref.py`` under one ``jax.jit`` per
(geometry, attention) computing both kernels' references, shared by the B3
and B4 cases; JAX's Pallas megakernels in interpret mode hold one ragged
geometry per flavour.

Tolerance: 1e-4 of max|state| (float32 trunks whose products sum in
another order), as ``test_torch_megastep.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import diffusion_lm as jdlm
from repro.core import make_schedule as j_make_schedule
from repro.kernels.megastep import MegaSpec as JMegaSpec
from repro.kernels.megastep import kernel as jk
from repro.kernels.megastep import ref as jmega_ref
from repro.kernels.sampler_step import ops as jops
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels.megastep import kernel as tk
from repro_torch.kernels.sampler_step import ops as step_ops
from repro_torch.models.common import ArchConfig as TArch

TOL_OF_SCALE = 1e-4
JSCH = j_make_schedule("linear", T=1000)
# name -> (ArchConfig fields, time_dim, latent, batch, seq_len)
CASES = {
    "L64-S32-hd8": (dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         head_dim=8), 32, 64, 2, 32),
    "L64-S96-hd24-d72-ff100": (dict(d_model=72, n_heads=3, n_kv_heads=1,
                                    d_ff=100), 32, 64, 2, 96),
    "L128-S16-hd48": (dict(d_model=96, n_heads=2, n_kv_heads=1, d_ff=128),
                      32, 128, 2, 16),
    "L128-S80-hd80": (dict(d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                           head_dim=80), 32, 128, 2, 80),
    "L256-S8-hd96": (dict(d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
                          head_dim=96), 32, 256, 2, 8),
    "L16-S128-hd112": (dict(d_model=64, n_heads=1, n_kv_heads=1, d_ff=128,
                            head_dim=112), 32, 16, 2, 128),
    "L256-S200-hd160": (dict(d_model=64, n_heads=1, n_kv_heads=1, d_ff=128,
                             head_dim=160), 32, 256, 1, 200),
    "L32-S64-hd256": (dict(d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
                           head_dim=256), 32, 32, 2, 64),
}
INTERPRET_CASE = "L128-S16-hd48"
IMPLS = ("exact", "flash")


def _weights(tree, rs):
    """numpy float32 leaves for a tree of shapes: products ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1)."""
    if isinstance(tree, dict):
        return {k: _weights(v, rs) for k, v in tree.items()}
    shape = tuple(tree)
    if len(shape) >= 2:
        return (rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)
    return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX cfg, port cfg, JAX weights, port weights, state) of a case."""
    arch, time_dim, latent, batch, seq = CASES[name]
    cfgs = [m.DiffusionLMConfig(arch=A(name=name, family="dense",
                                       n_layers=1, vocab=50, **arch),
                                time_dim=time_dim, latent_dim=latent)
            for m, A in ((jdlm, JArch), (tdlm, TArch))]
    shapes = tdlm.param_shapes(cfgs[1])
    rs = np.random.RandomState(sum(map(ord, name)))
    w = _weights({k: shapes[k] for k in tdlm.EPS_PATH}, rs)
    x2 = rs.randn(batch * seq * latent // 256, 256).astype(np.float32)
    return (*cfgs, jax.tree.map(jnp.asarray, w),
            jax.tree.map(torch.from_numpy, w), x2)


def _steps(batch):
    """B3's one step (coefs (1, 5), ts (1,)) and B4's per-slot ts (batch,)
    and coefficient rows (batch, 5), each slot at its own plan position."""
    tab = JPlan.build(JSCH, tau=10).steps()
    cols = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")
    rows = np.stack([tab[c] for c in cols], 1).astype(np.float32)
    ks = [2 + 3 * b for b in range(batch)]
    return (rows[3:4], np.array(tab["t"][3:4], np.int32),
            np.array(tab["t"][ks], np.int32), rows[ks])


@functools.lru_cache(maxsize=None)
def _jax_refs(name, impl):
    """JAX's megastep_ref (one step) and megastep_rows_ref (one tick) of a
    case, under one jit: the B3 and B4 cases share it."""
    jcfg, _, jw, _, x2 = _case(name)
    batch, seq = CASES[name][3:]
    coefs, ts, slot_ts, slot_coefs = _steps(batch)
    rows = jops.expand_slot_coefs(jnp.asarray(slot_coefs),
                                  x2.shape[0] // batch)

    @jax.jit
    def refs(x2, w, coefs, ts, rows, slot_ts):
        spec = JMegaSpec(params=w, cfg=jcfg, batch=batch, seq_len=seq,
                         attn_impl=impl)
        return (jmega_ref.megastep_ref(x2, spec, coefs, ts),
                jmega_ref.megastep_rows_ref(x2, spec, rows, slot_ts))
    return tuple(np.asarray(r) for r in refs(
        jnp.asarray(x2), jw, jnp.asarray(coefs), jnp.asarray(ts), rows,
        jnp.asarray(slot_ts)))


def _port(name, impl, rows: bool):
    _, tcfg, _, tw, x2 = _case(name)
    batch, seq = CASES[name][3:]
    coefs, ts, slot_ts, slot_coefs = _steps(batch)
    x = torch.from_numpy(x2.copy())
    if rows:
        trows = step_ops.expand_slot_coefs(torch.from_numpy(slot_coefs),
                                           x2.shape[0] // batch)
        return tk.megastep_rows_call(x, tw, tcfg, batch, seq, trows,
                                     torch.from_numpy(slot_ts),
                                     attn_impl=impl)
    return tk.megastep_call(x, tw, tcfg, batch, seq, torch.from_numpy(coefs),
                            torch.from_numpy(ts), attn_impl=impl)


def _check(got, want):
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert np.isfinite(got.numpy()).all()
    assert err <= TOL_OF_SCALE * np.abs(want).max()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CASES))
def test_megastep_call_geometry_matches_jax_ref(name, impl):
    """B3's plain version, one step, against JAX's megastep_ref."""
    n0 = tk.megastep_call.launches
    _check(_port(name, impl, rows=False), _jax_refs(name, impl)[0])
    assert tk.megastep_call.launches == n0          # CPU: plain version


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CASES))
def test_megastep_rows_call_geometry_matches_jax_ref(name, impl):
    """B4's plain version, one tick, against JAX's megastep_rows_ref."""
    _check(_port(name, impl, rows=True), _jax_refs(name, impl)[1])


@pytest.mark.parametrize("rows", [False, True], ids=["B3", "B4"])
@pytest.mark.parametrize("impl", IMPLS)
def test_geometry_matches_jax_kernel_interpret(impl, rows):
    """At seq_len 16, latent 128 (a 64-row tile holds both samples and ends
    past them) and head dim 48: the plain version against JAX's Pallas
    megakernel in interpret mode."""
    jcfg, _, jw, _, x2 = _case(INTERPRET_CASE)
    batch, seq = CASES[INTERPRET_CASE][3:]
    coefs, ts, slot_ts, slot_coefs = _steps(batch)
    leaves, treedef = jax.tree.flatten(jw)
    if rows:
        want = jk.megastep_rows_call(
            jnp.asarray(x2), leaves, treedef, jcfg, batch, seq,
            jops.expand_slot_coefs(jnp.asarray(slot_coefs),
                                   x2.shape[0] // batch),
            jnp.asarray(slot_ts), attn_impl=impl)
    else:
        want = jk.megastep_call(jnp.asarray(x2), leaves, treedef, jcfg,
                                batch, seq, jnp.asarray(coefs),
                                jnp.asarray(ts), attn_impl=impl)
    _check(_port(INTERPRET_CASE, impl, rows), np.asarray(want))
