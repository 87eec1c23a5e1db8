"""B3 / B4 on bfloat16 and float16 states and weights: the plain versions
the CUDA megakernel is held against on the card, against JAX's
megakernels.

The plain versions (``megastep_ref`` / ``megastep_rows_ref``, 'exact' and
'flash') against JAX's ``megastep_call`` / ``megastep_rows_call`` in
interpret mode, at the smallest widths (2 layers, d_model 64, 2 x 64
tokens, K = 2), for the state / weights type pairs: bf16 / bf16 (a
bfloat16 trunk), bf16 / f32 and f32 / bf16 (float32 trunks, promoted as
jnp promotes), and f16 / f16 (a float16 trunk), f16 / f32 and f16 / bf16
(float32 trunks: float16 with bfloat16 promotes to float32).  The trunk dtype follows JAX's rules, the sinusoid is cast
to the state's type, the state is rounded to its type after every step.

Tolerances, of max|state|: 2e-2 for a bfloat16 trunk (the repo's bfloat16
tolerance, ``tests/test_kernels.py``); 2e-2 for a bfloat16 state over a
float32 trunk too (a few bfloat16 ulps: one trunk difference of 1e-7 can
flip a rounding, and a flip is one ulp, 2^-8 of the value); 1e-4 where
state and trunk are float32 (the float32 trunk tolerance of
``test_torch_megastep.py``); 4 float16 ulps (4 x 2^-10) with a float16
state, over either trunk (both round the state to float16 after each
step; the float16 trunk's roundings sit where JAX's are).

Off the CPU the kernel's limits now admit those pairs (a meta tensor
stands for the card): a bfloat16 engine over a bfloat16 trunk takes the
mega tick (B4), and a 4-layer smollm-width bfloat16 trunk fits the budget
at 4 x 64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mega as mega_trunks
from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import make_schedule as j_make_schedule
from repro.kernels.megastep import kernel as jk
from repro.kernels.sampler_step import ops as jops
from repro.sampling import SamplerPlan as JPlan
from repro_torch import configs
from repro_torch.core import make_schedule
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels import megastep
from repro_torch.kernels.megastep import kernel as tk
from repro_torch.kernels.sampler_step import ops as step_ops
from repro_torch.serving import ContinuousBatchingEngine

JDT = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
COMBOS = [("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16"),
          ("f16", "f16"), ("f16", "f32"), ("f16", "bf16")]
IDS = [f"{s}-{w}" for s, w in COMBOS]
BATCH, SEQ, K = 2, 64, 2
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)


def _tol(state: str) -> float:
    return {"bf16": 2e-2, "f16": 4 * 2.0 ** -10}.get(state, 1e-4)


def _weights(weights: str):
    jcfg, tcfg, jp, tp = mega_trunks.trunk(16)
    jw = jax.tree.map(lambda a: a.astype(JDT[weights]),
                      {k: jp[k] for k in tdlm.EPS_PATH})
    tw = mega_trunks.cast({k: tp[k] for k in tdlm.EPS_PATH}, TDT[weights])
    return jcfg, tcfg, jw, tw


def _check(got, want, state):
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == TDT[state] and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _tol(state) * np.abs(want).max()


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
@pytest.mark.parametrize("state,weights", COMBOS, ids=IDS)
def test_megastep_ref_matches_jax_kernel(state, weights, attn_impl):
    """B3's plain version, K = 2 fused steps."""
    jcfg, tcfg, jw, tw = _weights(weights)
    tab = JPlan.build(JSCH, tau=4).steps()
    coefs = np.stack([tab[c] for c in ("c_x0", "c_dir", "c_noise",
                                       "sqrt_a_t", "sqrt_1m_a_t")],
                     1)[:K].astype(np.float32)
    ts = np.array(tab["t"][:K], np.int32)
    x2 = mega_trunks.state(BATCH, SEQ)
    leaves, treedef = jax.tree.flatten(jw)
    want = jk.megastep_call(jnp.asarray(x2).astype(JDT[state]), leaves,
                            treedef, jcfg, BATCH, SEQ, jnp.asarray(coefs),
                            jnp.asarray(ts), attn_impl=attn_impl)
    got = tk.megastep_call(torch.from_numpy(x2).to(TDT[state]), tw, tcfg,
                           BATCH, SEQ, torch.from_numpy(coefs),
                           torch.from_numpy(ts), attn_impl=attn_impl)
    _check(got, want, state)


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
@pytest.mark.parametrize("state,weights", COMBOS, ids=IDS)
def test_megastep_rows_ref_matches_jax_kernel(state, weights, attn_impl):
    """B4's plain version, one tick, each slot at its own timestep."""
    jcfg, tcfg, jw, tw = _weights(weights)
    tabs = [JPlan.build(JSCH, tau=S).steps() for S in (10, 25)]
    ts = np.array([tabs[0]["t"][2], tabs[1]["t"][20]], np.int32)
    slot_coefs = np.array(
        [[tab[c][k] for c in ("c_x0", "c_dir", "c_noise", "sqrt_a_t",
                              "sqrt_1m_a_t")]
         for tab, k in ((tabs[0], 2), (tabs[1], 20))], np.float32)
    x2 = mega_trunks.state(BATCH, SEQ)
    rps = x2.shape[0] // BATCH
    jrows = jops.expand_slot_coefs(jnp.asarray(slot_coefs), rps)
    leaves, treedef = jax.tree.flatten(jw)
    want = jk.megastep_rows_call(jnp.asarray(x2).astype(JDT[state]), leaves,
                                 treedef, jcfg, BATCH, SEQ, jrows,
                                 jnp.asarray(ts), attn_impl=attn_impl)
    got = tk.megastep_rows_call(
        torch.from_numpy(x2).to(TDT[state]), tw, tcfg, BATCH, SEQ,
        step_ops.expand_slot_coefs(torch.from_numpy(slot_coefs), rps),
        torch.from_numpy(ts), attn_impl=attn_impl)
    _check(got, want, state)


# ------------------------------------------------------ off the CPU
def _meta_eps(cfg, batch, seq, dtype, attn_impl="exact"):
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta", dtype=dtype)
    p = meta(tdlm.param_shapes(cfg))

    def eps(x2, t):
        raise AssertionError("never called")
    eps.slot_tile_aware = True
    eps.mega_spec = megastep.MegaSpec(
        params={k: p[k] for k in tdlm.EPS_PATH}, cfg=cfg, batch=batch,
        seq_len=seq, attn_impl=attn_impl)
    return eps


def _layers(n):
    cfg = configs.DLM_SMOLLM_MEGA
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch,
                                                             n_layers=n))


@pytest.mark.parametrize("slots,layers,impl", [(4, 2, "exact"),
                                               (8, 2, "flash"),
                                               (4, 4, "flash")],
                         ids=["2L-4x64", "2L-8x64", "4L-4x64"])
def test_bfloat16_engine_resolves_to_the_mega_tick(slots, layers, impl):
    """A bfloat16 engine over a bfloat16 trunk on the card (meta) takes
    B4: the kernel's limits admit it and bfloat16 weights fit the budget
    at 8 x 64 and at 4 layers (float32 weights do not)."""
    cfg = _layers(layers)
    shape = (64, cfg.latent_dim)
    eps = _meta_eps(cfg, slots, 64, torch.bfloat16, impl)
    eng = ContinuousBatchingEngine(TSCH, eps, shape, slots=slots,
                                   dtype=torch.bfloat16, device="meta")
    assert eng.use_mega and eng.tick_variant == "mega"
    eps32 = _meta_eps(cfg, slots, 64, torch.float32, impl)
    eng32 = ContinuousBatchingEngine(TSCH, eps32, shape, slots=slots,
                                     dtype=torch.bfloat16, device="meta")
    assert eng32.use_mega == (slots == 4 and layers == 2)


@pytest.mark.parametrize("state,weights", COMBOS, ids=IDS)
def test_kernel_takes_bfloat16_pairs_and_checks_their_inputs(state, weights):
    """kernel_limits admits the pair and the launcher's checks pass it (a
    meta state stands for the card)."""
    cfg = configs.DLM_SMOLLM_MEGA
    eps = _meta_eps(cfg, 4, 64, TDT[weights])
    spec = eps.mega_spec
    assert tk.kernel_limits(cfg, TDT[state], spec.params) == (True, "ok")
    x2 = torch.empty(4 * 64 * cfg.latent_dim // 256, 256, dtype=TDT[state],
                     device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk._check_kernel_inputs(x2, spec.params, cfg)
