"""B3 megastep and ``backend='mega'`` of the port against the JAX package.

Sizes are those of ``test_megastep.py`` (d_model 64, batch 2, 64 tokens,
latent 32), weights from the JAX ``init_params`` through ``interop``.  The
JAX oracle is ``backend='jnp'`` and ``megastep.ref.megastep_ref``, not
JAX's interpret-mode megakernel (which drifts ~1e-4 from 'jnp' at K >= 2
on this jax).

Past the slice's geometry, the trunks of ``tests/_torch_mega.py``: 128
and 256 tokens at head dims 16, 32, 64 and 128; the geometries past those
(ragged tiles, off-tile widths, head dims 2 to 256) are
``test_torch_megastep_geometry.py``'s.  Off the CPU (meta tensors stand for
the card) the kernel's limits admit every input JAX's megakernel computes,
head dims past 256 and weights of several types among them, and
``eligible`` then gives JAX's answer; they refuse only what JAX raises on:
a state of another type (float64), an odd head dim and GQA groups of
partial heads.  Head dim 288 (1 layer) and a tree of bfloat16 matrices
over float32 vectors run 'mega' against JAX's 'jnp' (float32 and
bfloat16 states; 2e-2 of the largest state in bfloat16, as
``test_torch_megastep_bf16.py``).

Tolerances: 1e-4 of the largest state (float32 trunks whose products sum
in another order, carried through the steps).  Port 'mega' with 'exact'
attention equals port 'tile_resident' bitwise: on the CPU both run the
same eps and the same step arithmetic.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mega as mega_trunks
from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import diffusion_lm as jdlm
from repro.core import make_schedule as j_make_schedule
from repro.kernels.megastep import ref as jmega_ref
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro_torch import prng
from repro_torch import configs, interop
from repro_torch.core import make_schedule
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels import megastep
from repro_torch.kernels.megastep import kernel as tk
from repro_torch.kernels.megastep import ops as tops
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling import backends as tback

TOL_OF_SCALE = 1e-4
B, SEQ, LATENT = 2, 64, 32
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)


def _models(n_heads=2, n_kv_heads=2):
    arch = dict(n_layers=2, d_model=64, n_heads=n_heads,
                n_kv_heads=n_kv_heads, d_ff=128, vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    x = np.random.RandomState(1).randn(B, SEQ, LATENT).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _flash(eps_fn):
    eps_fn.mega_spec = dataclasses.replace(eps_fn.mega_spec,
                                           attn_impl="flash")
    return eps_fn


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ------------------------------------------------------------ one chunk
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("clip", [None, 1.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_megastep_call_matches_jax_ref(attn_impl, clip, K):
    jcfg, tcfg, jp, tp, x = _models(n_heads=4, n_kv_heads=2)
    plan = JPlan.build(JSCH, tau=K + 2, x0=clip)
    tab = plan.steps()
    coefs = np.stack([tab["c_x0"], tab["c_dir"], tab["c_noise"],
                      tab["sqrt_a_t"], tab["sqrt_1m_a_t"]], 1)[:K]
    ts = np.array(tab["t"][:K], np.int32)
    x2 = x.reshape(-1, 256)
    want = mega_trunks.jit_ref(jmega_ref.megastep_ref, jcfg, B, SEQ,
                               attn_impl, clip=clip)(
        jnp.asarray(x2), {k: jp[k] for k in tdlm.EPS_PATH},
        jnp.asarray(coefs), jnp.asarray(ts))
    got = tk.megastep_call(torch.from_numpy(x2.copy()), tp, tcfg, B, SEQ,
                           torch.from_numpy(coefs.copy()),
                           torch.from_numpy(ts), clip=clip,
                           attn_impl=attn_impl)
    assert got.shape == x2.shape
    assert _rel(got, want) <= TOL_OF_SCALE


def _plan_cols(tau, K, clip=None):
    tab = JPlan.build(JSCH, tau=tau, x0=clip).steps()
    coefs = np.stack([tab["c_x0"], tab["c_dir"], tab["c_noise"],
                      tab["sqrt_a_t"], tab["sqrt_1m_a_t"]], 1)[:K]
    return coefs, np.array(tab["t"][:K], np.int32)


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
@pytest.mark.parametrize("hd", sorted(mega_trunks.HEAD_DIMS),
                         ids=lambda d: f"hd{d}")
@pytest.mark.parametrize("seq", mega_trunks.SEQS, ids=lambda s: f"S{s}")
def test_megastep_call_long_seq_head_dims_match_jax_ref(seq, hd, attn_impl):
    """B3's plain version at 2 x 128 and 1 x 256 tokens, head dims 16 to
    128, against JAX's megastep_ref (2 steps)."""
    jcfg, tcfg, jp, tp = mega_trunks.trunk(hd)
    batch = 256 // seq
    coefs, ts = _plan_cols(4, 1)
    x2 = mega_trunks.state(batch, seq)
    want = mega_trunks.jit_ref(jmega_ref.megastep_ref, jcfg, batch, seq,
                               attn_impl)(
        jnp.asarray(x2), {k: jp[k] for k in tdlm.EPS_PATH},
        jnp.asarray(coefs), jnp.asarray(ts))
    got = tk.megastep_call(torch.from_numpy(x2.copy()), tp, tcfg, batch, seq,
                           torch.from_numpy(coefs.copy()),
                           torch.from_numpy(ts), attn_impl=attn_impl)
    assert got.shape == x2.shape
    assert _rel(got, want) <= TOL_OF_SCALE


# ------------------------------------------------------------ the slice
@pytest.mark.parametrize("k_fuse", [1, 4, 8], ids=["K1", "K4-ragged", "K8"])
@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_plan_run_mega_matches_jax_jnp(attn_impl, k_fuse):
    jcfg, tcfg, jp, tp, x = _models()
    want = JPlan.build(JSCH, tau=6).run(jdlm.make_eps_fn(jp, jcfg),
                                        jnp.asarray(x), backend="jnp")
    eps = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ)
    if attn_impl == "flash":
        eps = _flash(eps)
    got = SamplerPlan.build(TSCH, 6).run(eps, torch.from_numpy(x),
                                         backend="mega", k_fuse=k_fuse)
    assert tback.run_mega.last_reason == "ok"
    assert _rel(got, want) <= TOL_OF_SCALE


def _wide_or_mixed(case):
    """(JAX cfg, port cfg, JAX params, port params) of the cases past the
    kernel's old limits: 'hd288', a 1-layer trunk of two heads of 288 over
    one kv head (d_model 64); 'mixed', the 2-layer trunk of ``_models``
    with every matrix in bfloat16 but w_in, and its vectors (the norm
    scales) in float32.  (w_in stays float32 so that a bfloat16 state's h
    enters the layers as float32: JAX scans the layers and refuses a
    layer that changes h's type.)"""
    if case == "hd288":
        arch = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1,
                    d_ff=128, vocab=50, head_dim=288)
        jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                                 **arch), time_dim=32)
        tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                                 **arch), time_dim=32)
        jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
        return jcfg, tcfg, jp, interop.dlm_params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg)
    jcfg, tcfg, jp, tp, _ = _models()

    def cast(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        keep = keys[-1].endswith("norm") or keys[-1] == "w_in"
        return leaf if keep else leaf.astype(jnp.bfloat16)
    jp = jax.tree_util.tree_map_with_path(cast, jp)
    tp = {k: (_matrices_to(v, torch.bfloat16, k) if k != "w_in" else v)
          for k, v in tp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["hd288", "mixed"])
def test_plan_run_mega_past_the_old_limits_matches_jax_jnp(case, state):
    """'mega' on a trunk the kernel took only from this slice on (head dim
    288; weights of two types) against JAX's 'jnp', float32 and bfloat16
    states; off the CPU the same trunks are eligible."""
    jcfg, tcfg, jp, tp = _wide_or_mixed(case)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[state]
    x = np.random.RandomState(1).randn(B, SEQ, LATENT).astype(np.float32)
    want = JPlan.build(JSCH, tau=4).run(jdlm.make_eps_fn(jp, jcfg),
                                        jnp.asarray(x, jdt), backend="jnp")
    eps = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ)
    xT = torch.from_numpy(x).to(tdt)
    got = SamplerPlan.build(TSCH, 4).run(eps, xT, backend="mega", k_fuse=2)
    assert tback.run_mega.last_reason == "ok" and got.dtype == tdt
    tol = 1e-4 if state == "f32" else 2e-2
    assert _rel(got.float(), np.asarray(want, np.float32)) <= tol
    assert megastep.eligible(eps.mega_spec, torch.empty(
        xT.shape, dtype=tdt, device="meta")) == (True, "ok")


@pytest.mark.parametrize("k_fuse,clip,heads", [
    (1, None, (2, 2)), (3, None, (2, 2)), (8, None, (2, 2)),
    (3, 1.5, (4, 2))], ids=["K1", "K3", "K8", "K3-clip-gqa"])
def test_mega_exact_equals_tile_resident_bitwise(k_fuse, clip, heads):
    _, tcfg, _, tp, x = _models(*heads)
    eps = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ)
    plan = SamplerPlan.build(TSCH, 7, x0=clip)
    xT = torch.from_numpy(x)
    mega = plan.run(eps, xT, backend="mega", k_fuse=k_fuse)
    assert tback.run_mega.last_reason == "ok"
    tile = plan.run(eps, xT, backend="tile_resident")
    torch.testing.assert_close(mega, tile, rtol=0, atol=0)


@pytest.mark.parametrize("hd", [32, 128], ids=["hd32", "hd128"])
def test_mega_exact_equals_tile_resident_bitwise_at_128_tokens(hd):
    _, tcfg, _, tp = mega_trunks.trunk(hd)
    eps = tdlm.make_tile_eps_fn(tp, tcfg, 2, 128)
    plan = SamplerPlan.build(TSCH, 5)
    xT = torch.from_numpy(mega_trunks.state(2, 128).reshape(2, 128, LATENT))
    mega = plan.run(eps, xT, backend="mega", k_fuse=3)
    assert tback.run_mega.last_reason == "ok"
    tile = plan.run(eps, xT, backend="tile_resident")
    torch.testing.assert_close(mega, tile, rtol=0, atol=0)


# ---------------------------------------------------------- eligibility
def _meta_spec(cfg, batch, attn_impl="exact", seq_len=SEQ,
               dtype=torch.float32):
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta", dtype=dtype)
    p = meta(tdlm.param_shapes(cfg))
    return megastep.MegaSpec(params={k: p[k] for k in tdlm.EPS_PATH},
                             cfg=cfg, batch=batch, seq_len=seq_len,
                             attn_impl=attn_impl)


@pytest.mark.parametrize("cfg,batch,impl,total,ok", [
    ("DLM_SMOLLM_MEGA", 4, "exact", 35_482_880, True),
    ("DLM_SMOLLM_MEGA", 4, "flash", 36_072_704, True),
    ("DLM_SMOLLM_MEGA", 8, "flash", 42_822_912, False),
    ("DLM_SMOLLM", 4, "exact", 431_973_632, False)],
    ids=["2L-b4-exact", "2L-b4-flash", "2L-b8-flash", "30L-b4-exact"])
def test_eligibility_of_the_smollm_trunks(cfg, batch, impl, total, ok):
    spec = _meta_spec(getattr(configs, cfg), batch, impl)
    assert spec.vmem_bytes() == total
    got, why = megastep.eligible(spec, torch.empty(batch, SEQ, LATENT,
                                                   device="meta"))
    assert got == ok
    assert (why == "ok") if ok else ("budget 39321600 B" in why)
    assert megastep.MEGA_BUDGET == 39_321_600 == int(0.75 * 50 * 2 ** 20)


def test_eligibility_reasons():
    _, tcfg, _, tp, x = _models()
    spec = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ).mega_spec
    xT = torch.from_numpy(x)
    assert megastep.eligible(spec, xT) == (True, "ok")
    assert "mega_spec" in megastep.eligible(None, xT)[1]
    assert "geometry" in megastep.eligible(spec, xT[:, :32])[1]
    assert "budget 1024 B" in megastep.eligible(spec, xT, budget=1024)[1]
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(spec, attn_impl="chunked")


# The CUDA megakernel's own limits (kernel_limits), which are what JAX's
# kernel raises on: a state of a type it has no code for (float64), an
# odd head dim (RoPE's halves: JAX's array split fails) and n_heads no
# multiple of n_kv_heads.  A state off the CPU (meta stands for the card)
# meets them or is not eligible; a CPU state keeps the JAX rule.
LIMIT_CASES = {
    "state_dtype": dict(state=torch.float64, what="dtype torch.float64"),
    "head_dim_9": dict(cfg=(1, 1, 64, 9), what="an even head_dim (RoPE's "
                       "halves), got head_dim 9"),
    "heads_3_over_2": dict(cfg=(3, 2, 64, 16), what="n_heads a multiple of "
                           "n_kv_heads, got 3 and 2"),
}
# Geometries past the limits the kernel had until it took every one JAX's
# megakernel admits, each now admitted: seq_len 96 at latent 64 (a 64-row
# tile straddles two samples), head dim 8, head dim 16 with one kv head (16
# k and v columns: tiles cut mid-way), DLM_SMOLLM_MEGA at the main path's
# latents and geometries (16 at 2 x 128, 64 at 4 x 32, 128 at 2 x 80 and
# 256 at 1 x 200, which also passes the old latent <= 128), head dims 2 and
# 256, d_model 72 with d_ff 100, odd widths (d_model 75, d_ff 101, head dim
# 10, time_dim 31), a latent of 3 (2,048 tokens: whole tile granules), and
# a float16 state over float32 weights (a float32 trunk).  Past the limits
# the kernel had until it took JAX's whole domain: weights of two types
# (one bfloat16 leaf among float32, and bfloat16 matrices over float32
# vectors), and head dims 264, 288, 576 and 1,024.
ADMIT_CASES = {
    "weight_dtype": dict(weights="mixed"),
    "matrices_bf16": dict(weights="matrices"),
    "head_dim_264": dict(cfg=(1, 1, 64, 264)),
    "head_dim_288": dict(cfg=(2, 1, 64, 288)),
    "head_dim_576": dict(cfg=(1, 1, 64, 576)),
    "head_dim_1024": dict(cfg=(1, 1, 64, 1024)),
    "state_float16": dict(state=torch.float16),
    "seq_len": dict(cfg="latent64", batch=2, seq=96),
    "head_dim": dict(cfg=(8, 4)),
    "widths": dict(cfg=(4, 1)),
    "smollm-L16-2x128": dict(cfg="latent16", batch=2, seq=128),
    "smollm-L64-4x32": dict(cfg="latent64", batch=4, seq=32),
    "smollm-L128-2x80": dict(cfg="latent128", batch=2, seq=80),
    "smollm-L256-1x200": dict(cfg="latent256", batch=1, seq=200),
    "head_dim_2": dict(cfg=(2, 2, 64, 2)),
    "head_dim_256": dict(cfg=(2, 1, 64, 256)),
    "d72-ff100": dict(cfg=(3, 1, 72), d_ff=100),
    "odd-widths": dict(cfg=(3, 3, 75, 10), d_ff=101, time_dim=31),
    "latent3": dict(cfg=(1, 1), latent=3, batch=1, seq=2048),
}


def _small_cfg(n_heads, n_kv_heads, d_model=64, head_dim=None, d_ff=128,
               time_dim=32, latent=32):
    return tdlm.DiffusionLMConfig(arch=TArch(
        name="t", family="dense", n_layers=2, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff, vocab=50,
        head_dim=head_dim), time_dim=time_dim, latent_dim=latent)


def _limit_case(case, cases=LIMIT_CASES):
    c = cases[case]
    cfg = c.get("cfg")
    if isinstance(cfg, str):            # DLM_SMOLLM_MEGA at another latent
        cfg = dataclasses.replace(configs.DLM_SMOLLM_MEGA,
                                  latent_dim=int(cfg[len("latent"):]))
    elif cfg is None:
        cfg = configs.DLM_SMOLLM_MEGA
    else:
        cfg = _small_cfg(*cfg, **{k: c[k] for k in ("d_ff", "time_dim",
                                                    "latent") if k in c})
    batch, seq = c.get("batch", 4 if cfg.arch.d_model > 64 else B), \
        c.get("seq", SEQ)
    spec = _meta_spec(cfg, batch, seq_len=seq)
    if c.get("weights") == "mixed":     # one bfloat16 leaf among float32
        spec.params["w_out"] = spec.params["w_out"].to(torch.bfloat16)
    elif c.get("weights") == "matrices":  # bfloat16 matrices, float32 rest
        spec.params = _matrices_to(spec.params, torch.bfloat16)
    return spec, (batch, seq, cfg.latent_dim), c.get("state", torch.float32)


def _matrices_to(tree, dtype, key=""):
    """A tree with every matrix leaf cast to ``dtype`` and every vector
    leaf (the norm scales, stacked or not) kept."""
    if isinstance(tree, dict):
        return {k: _matrices_to(v, dtype, k) for k, v in tree.items()}
    return tree if key.endswith("norm") else tree.to(dtype)


@pytest.mark.parametrize("case", list(LIMIT_CASES))
def test_kernel_limits_name_the_limit(case):
    spec, shape, dtype = _limit_case(case)
    ok, why = tk.kernel_limits(spec.cfg, dtype, spec.params)
    assert not ok and LIMIT_CASES[case]["what"] in why
    assert "CUDA megakernel" in why
    # off the CPU the eligibility rule takes the kernel's reason
    assert megastep.eligible(spec, torch.empty(shape, dtype=dtype,
                                               device="meta")) == (ok, why)
    # a CPU state keeps the JAX rule, which the plain version runs
    assert megastep.eligible(spec, torch.empty(shape, dtype=dtype)) == (
        True, "ok")


@pytest.mark.parametrize("case", list(ADMIT_CASES))
def test_kernel_limits_admit_every_geometry_jax_admits(case):
    """kernel_limits and eligible admit the geometry off the CPU, and the
    launcher's checks pass it up to the device check (a meta state stands
    for the card)."""
    spec, shape, dtype = _limit_case(case, ADMIT_CASES)
    assert tk.kernel_limits(spec.cfg, dtype, spec.params) == (True, "ok")
    assert megastep.eligible(spec, torch.empty(shape, dtype=dtype,
                                               device="meta")) == (True, "ok")
    x2 = torch.empty(math.prod(shape) // 256, 256, dtype=dtype,
                     device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk._check_kernel_inputs(x2, spec.params, spec.cfg)


@pytest.mark.parametrize("case", list(LIMIT_CASES))
def test_kernel_launcher_refuses_what_kernel_limits_refuses(case):
    """The launcher's checks (a meta state stands for the card) raise the
    reason kernel_limits gives, before anything is built or launched."""
    spec, shape, dtype = _limit_case(case)
    why = tk.kernel_limits(spec.cfg, dtype, spec.params)[1]
    x2 = torch.empty(math.prod(shape) // 256, 256, dtype=dtype,
                     device="meta")
    with pytest.raises(ValueError) as err:
        tk._check_kernel_inputs(x2, spec.params, spec.cfg)
    assert why in str(err.value)


def _jax_spec(spec):
    """JAX's MegaSpec of the same trunk, geometry and leaf types, its leaves
    shape / dtype stand-ins (JAX's eligibility reads only those)."""
    from repro.kernels.megastep import MegaSpec as JMegaSpec
    a = spec.cfg.arch
    jcfg = jdlm.DiffusionLMConfig(
        arch=JArch(**{f.name: getattr(a, f.name)
                      for f in dataclasses.fields(JArch)}),
        time_dim=spec.cfg.time_dim, latent_dim=spec.cfg.latent_dim)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}

    def stand_in(tree):
        if isinstance(tree, dict):
            return {k: stand_in(v) for k, v in tree.items()}
        return jax.ShapeDtypeStruct(tuple(tree.shape), jdt[tree.dtype])
    return JMegaSpec(params=stand_in(spec.params), cfg=jcfg,
                     batch=spec.batch, seq_len=spec.seq_len,
                     attn_impl=spec.attn_impl), jdt


@pytest.mark.parametrize("case", list(ADMIT_CASES))
def test_eligible_off_the_cpu_equals_jax_eligible(case):
    """On every input JAX's megakernel computes, the port's eligibility of
    a state off the CPU is JAX's (at the port's budget, which both take:
    JAX's own is a TPU's VMEM share)."""
    from repro.kernels.megastep import eligible as j_eligible
    spec, shape, dtype = _limit_case(case, ADMIT_CASES)
    jspec, jdt = _jax_spec(spec)
    want = j_eligible(jspec, jax.ShapeDtypeStruct(shape, jdt[dtype]),
                      budget=megastep.MEGA_BUDGET)
    assert want == (True, "ok")
    assert megastep.eligible(spec, torch.empty(shape, dtype=dtype,
                                               device="meta"),
                             budget=megastep.MEGA_BUDGET) == want


def _bench_mega_cfg():
    """The JAX package's recorded mega trunk (benchmarks/sampler_overhead.py
    ``_mega_model``): d_model 64, 2 heads of 32, time_dim 64."""
    cfg = _small_cfg(2, 2)
    return dataclasses.replace(cfg, time_dim=64)


def test_kernel_limits_admit_the_slice():
    """The slice's 4 x 64, DLM_SMOLLM_MEGA at 2 x 128 and 1 x 256, the bench
    trunk (head dim 32) at 32 x 64, and head dims 16 and 128; each with
    the three bfloat16 state / weights pairs too; and a 4-layer
    smollm-width trunk in bfloat16 at 4 x 64, which fits the budget only
    with bfloat16 weights."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(configs.DLM_SMOLLM_MEGA, 4, SEQ),
             (configs.DLM_SMOLLM_MEGA, 2, 128),
             (configs.DLM_SMOLLM_MEGA, 1, 256),
             (_bench_mega_cfg(), 32, 64),
             (_small_cfg(4, 2), 2, 128),
             (_small_cfg(1, 1, d_model=128), 1, 256)]
    for cfg, batch, seq in cases:
        for state, weights in ((f32, f32), (bf16, bf16), (bf16, f32),
                               (f32, bf16)):
            spec = _meta_spec(cfg, batch, seq_len=seq, dtype=weights)
            assert tk.kernel_limits(spec.cfg, state,
                                    spec.params) == (True, "ok")
            assert megastep.eligible(spec, torch.empty(
                batch, seq, cfg.latent_dim, dtype=state,
                device="meta")) == (True, "ok")
    assert _bench_mega_cfg().arch.hd() == 32
    mega = configs.DLM_SMOLLM_MEGA
    deep = dataclasses.replace(mega, arch=dataclasses.replace(mega.arch,
                                                              n_layers=4))
    for weights, fits in ((bf16, True), (f32, False)):
        spec = _meta_spec(deep, 4, seq_len=SEQ, dtype=weights)
        assert tk.kernel_limits(deep, bf16, spec.params) == (True, "ok")
        ok, why = megastep.eligible(spec, torch.empty(
            4, SEQ, deep.latent_dim, dtype=bf16, device="meta"))
        assert ok == fits and (fits or "budget 39321600 B" in why)


def test_engine_off_the_cpu_takes_rows_for_the_kernel_limits():
    from repro_torch.serving import ContinuousBatchingEngine
    spec, shape, _ = _limit_case("head_dim_9")

    def eps(x2, t):
        raise AssertionError("never called")
    eps.slot_tile_aware = True
    eps.mega_spec = spec
    for device, want in (("cpu", True), ("meta", False)):
        eng = ContinuousBatchingEngine(TSCH, eps, shape[1:], slots=shape[0],
                                       device=device)
        assert eng.use_mega == want
        assert eng.tick_variant == ("mega" if want else "rows")
    with pytest.raises(ValueError, match="use_mega=True but the CUDA "
                       "megakernel takes an even head_dim \\(RoPE's "
                       "halves\\), got head_dim 9"):
        ContinuousBatchingEngine(TSCH, eps, shape[1:], slots=shape[0],
                                 use_mega=True, device="meta")
    # 2 slots of 128 tokens and, at latent 64, 2 of 96 and 4 of 32 are in
    # the kernel's domain: B4 off the CPU too
    for case in ("seq_len", "smollm-L64-4x32"):
        spec, shape, _ = _limit_case(case, ADMIT_CASES)
        eps.mega_spec = spec
        eng = ContinuousBatchingEngine(TSCH, eps, shape[1:], slots=shape[0],
                                       device="meta")
        assert eng.use_mega and eng.tick_variant == "mega"
    eps.mega_spec = _meta_spec(configs.DLM_SMOLLM_MEGA, 2, seq_len=128)
    eng = ContinuousBatchingEngine(
        TSCH, eps, (128, configs.DLM_SMOLLM_MEGA.latent_dim), slots=2,
        device="meta")
    assert eng.use_mega and eng.tick_variant == "mega"


def _count_chunks(monkeypatch):
    calls = []
    real = megastep.megastep_tiles

    def spy(*a, **kw):
        calls.append(a[3].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(megastep, "megastep_tiles", spy)
    return calls


@pytest.mark.parametrize("case", ["stochastic", "order2", "no-spec",
                                  "wrong-shape", "over-budget"])
def test_ineligible_runs_take_the_tile_resident_loop(case, monkeypatch):
    _, tcfg, _, tp, x = _models()
    eps = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ)
    plan = SamplerPlan.build(TSCH, 5)
    xT = torch.from_numpy(x)
    why = {"stochastic": "stochastic", "order2": "order 2",
           "no-spec": "mega_spec", "wrong-shape": "geometry",
           "over-budget": "budget"}[case]
    if case == "stochastic":
        plan = SamplerPlan.build(TSCH, 5, sigma=1.0)
    elif case == "order2":
        plan = SamplerPlan.build(TSCH, 5, order=2)
    elif case == "no-spec":
        del eps.mega_spec
    elif case == "wrong-shape":
        xT = xT[:1]
    else:
        monkeypatch.setattr(tops, "MEGA_BUDGET", 1024)
    calls = _count_chunks(monkeypatch)
    gen = lambda: prng.PRNGKey(7, "cpu")  # noqa: E731
    if case == "wrong-shape":   # natural-shape eps still carrying the spec
        spec, eps = eps.mega_spec, tdlm.make_eps_fn(tp, tcfg)
        eps.mega_spec = spec
    got = plan.run(eps, xT, gen(), backend="mega")
    assert calls == [] and why in tback.run_mega.last_reason
    want = plan.run(eps, xT, gen(), backend="tile_resident")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("S,K", [(20, 8), (6, 4), (5, 8), (7, 1)])
def test_eligible_runs_launch_ceil_s_over_k_chunks(S, K, monkeypatch):
    _, tcfg, _, tp, x = _models()
    eps = tdlm.make_tile_eps_fn(tp, tcfg, B, SEQ)
    calls = _count_chunks(monkeypatch)
    SamplerPlan.build(TSCH, S).run(eps, torch.from_numpy(x), backend="mega",
                                   k_fuse=K)
    K = min(K, S)
    assert calls == [K] * (S // K) + ([S % K] if S % K else [])


def test_megastep_call_refuses_padding_and_counts_nothing_on_cpu():
    _, tcfg, _, tp, x = _models()
    x2 = torch.from_numpy(x.reshape(-1, 256).copy())
    c = torch.tensor([[0.9, 0.3, 0.0, 0.6, 0.8]])
    t = torch.tensor([500], dtype=torch.int32)
    padded = torch.cat([x2, torch.zeros(8, 256)])
    with pytest.raises(ValueError, match="pure reshape"):
        tk.megastep_call(padded, tp, tcfg, B, SEQ, c, t)
    with pytest.raises(ValueError, match=r"\(K, 5\)"):
        tk.megastep_call(x2, tp, tcfg, B, SEQ, c[:, :4], t)
    n0 = tk.megastep_call.launches
    tk.megastep_call(x2, tp, tcfg, B, SEQ, c, t)
    assert tk.megastep_call.launches == n0
