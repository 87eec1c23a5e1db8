"""B4, the fused scheduler tick (``megastep_rows_call``), and the
scheduler's mega tick against the JAX package.

Sizes are those of ``test_torch_megastep.py`` (d_model 64, 2 layers, 64
tokens, latent 32), weights from the JAX ``init_params`` through
``interop``; every slot has its own timestep and its own coefficient row.
Past the slice's geometry, 2 slots of 128 and 256 tokens over the trunks
of ``tests/_torch_mega.py`` (head dims 16, 32, 64 and 128).

Tolerances: the plain version against JAX ``megastep_rows_ref``, 1e-4 of
max|state| (float32 trunks whose products sum in another order), as for
B3.  The port's mega-tick engine ('exact') equals the port's unfused
engine bitwise on the CPU: both run the same eps and the same per-row
update arithmetic.
"""
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
from repro.kernels.sampler_step import ops as jops
from repro.models.common import ArchConfig as JArch
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro_torch import configs, interop
from repro_torch.core import make_schedule
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels import megastep
from repro_torch.kernels.megastep import kernel as tk
from repro_torch.kernels.megastep import ops as tops
from repro_torch.kernels.sampler_step import kernel as step_k
from repro_torch.kernels.sampler_step import ops as step_ops
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan
from repro_torch.serving import ContinuousBatchingEngine, SampleRequest

TOL_OF_SCALE = 1e-4
SLOTS, SEQ, LATENT = 3, 64, 32
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)


def _models(n_heads=4, n_kv_heads=2, batch=SLOTS):
    arch = dict(n_layers=2, d_model=64, n_heads=n_heads,
                n_kv_heads=n_kv_heads, d_ff=128, vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    x = np.random.RandomState(1).randn(batch, SEQ, LATENT).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _slot_rows(clip):
    """Per-slot (t, coefficient row) from three different plans at three
    different positions."""
    ts, rows = [], []
    for b, (S, k) in enumerate([(10, 2), (25, 20), (4, 3)]):
        tab = SamplerPlan.build(TSCH, S, x0=clip).steps()
        ts.append(tab["t"][k])
        rows.append([tab[c][k] for c in ("c_x0", "c_dir", "c_noise",
                                         "sqrt_a_t", "sqrt_1m_a_t")])
    return np.array(ts, np.int32), np.array(rows, np.float32)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_megastep_rows_call_matches_jax_ref(attn_impl, clip):
    jcfg, tcfg, jp, tp, x = _models()
    ts, slot_coefs = _slot_rows(clip)
    assert len(set(ts.tolist())) == SLOTS
    x2 = x.reshape(-1, 256)
    rps = x2.shape[0] // SLOTS
    jrows = jops.expand_slot_coefs(jnp.asarray(slot_coefs), rps)
    trows = step_ops.expand_slot_coefs(torch.from_numpy(slot_coefs), rps)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    want = mega_trunks.jit_ref(jmega_ref.megastep_rows_ref, jcfg, SLOTS, SEQ,
                               attn_impl, clip=clip)(
        jnp.asarray(x2), {k: jp[k] for k in tdlm.EPS_PATH}, jrows,
        jnp.asarray(ts))
    n0 = tk.megastep_rows_call.launches
    got = tk.megastep_rows_call(torch.from_numpy(x2.copy()), tp, tcfg, SLOTS,
                                SEQ, trows, torch.from_numpy(ts), clip=clip,
                                attn_impl=attn_impl)
    assert tk.megastep_rows_call.launches == n0      # CPU: plain version
    want = np.asarray(want)
    assert got.shape == x2.shape
    assert (np.abs(got.numpy() - want).max()
            <= TOL_OF_SCALE * np.abs(want).max())


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
@pytest.mark.parametrize("hd", sorted(mega_trunks.HEAD_DIMS),
                         ids=lambda d: f"hd{d}")
@pytest.mark.parametrize("seq", mega_trunks.SEQS, ids=lambda s: f"S{s}")
def test_megastep_rows_call_long_seq_head_dims_match_jax_ref(seq, hd,
                                                             attn_impl):
    """B4's plain version, 2 slots of 128 and 256 tokens, head dims 16 to
    128, against JAX's megastep_rows_ref."""
    jcfg, tcfg, jp, tp = mega_trunks.trunk(hd)
    slots = 2
    ts, slot_coefs = (a[:slots] for a in _slot_rows(None))
    x2 = mega_trunks.state(slots, seq)
    rps = x2.shape[0] // slots
    jrows = jops.expand_slot_coefs(jnp.asarray(slot_coefs), rps)
    trows = step_ops.expand_slot_coefs(torch.from_numpy(slot_coefs), rps)
    want = np.asarray(mega_trunks.jit_ref(
        jmega_ref.megastep_rows_ref, jcfg, slots, seq, attn_impl)(
        jnp.asarray(x2), {k: jp[k] for k in tdlm.EPS_PATH}, jrows,
        jnp.asarray(ts)))
    got = tk.megastep_rows_call(torch.from_numpy(x2.copy()), tp, tcfg, slots,
                                seq, trows, torch.from_numpy(ts),
                                attn_impl=attn_impl)
    assert got.shape == x2.shape
    assert (np.abs(got.numpy() - want).max()
            <= TOL_OF_SCALE * np.abs(want).max())


def test_megastep_rows_call_checks_inputs():
    _, tcfg, _, tp, x = _models()
    x2 = torch.from_numpy(x.reshape(-1, 256).copy())
    rows = torch.zeros(x2.shape[0], 8)
    t = torch.tensor([500, 20, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="pure reshape"):
        tk.megastep_rows_call(torch.cat([x2, torch.zeros(8, 256)]), tp,
                              tcfg, SLOTS, SEQ, rows, t)
    with pytest.raises(ValueError, match="row_coefs"):
        tk.megastep_rows_call(x2, tp, tcfg, SLOTS, SEQ, rows[:, :5], t)
    with pytest.raises(ValueError, match="slot_ts"):
        tk.megastep_rows_call(x2, tp, tcfg, SLOTS, SEQ, rows, t[:2])
    meta = x2.to("meta")
    with pytest.raises((ValueError, TypeError)):
        tk.megastep_rows_call(meta, tp, tcfg, SLOTS, SEQ, rows.to("meta"),
                              t.to("meta"))


def _serve(eng, seed0=0):
    reqs = [SampleRequest(request_id=i, S=s, seed=seed0 + i)
            for i, s in enumerate([3, 5, 2, 4])]
    return {r.request_id: r.x0 for r in eng.serve(reqs)}


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
def test_mega_tick_engine_equals_unfused_engine_bitwise(clip, monkeypatch):
    _, tcfg, _, tp, _ = _models()
    eps = tdlm.make_tile_eps_fn(tp, tcfg, SLOTS, SEQ)
    assert eps.slot_tile_aware
    calls = []
    real = megastep.megastep_rows
    monkeypatch.setattr(megastep, "megastep_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(slots=SLOTS, clip_x0=clip, device="cpu")
    mega = ContinuousBatchingEngine(TSCH, eps, (SEQ, LATENT), **kw)
    plain = ContinuousBatchingEngine(TSCH, eps, (SEQ, LATENT),
                                     use_mega=False, **kw)
    assert mega.stats()["mega_tick"] and mega.tick_variant == "mega"
    assert not plain.stats()["mega_tick"]
    got, want = _serve(mega), _serve(plain)
    assert len(calls) == mega.ticks > 0
    assert mega.ticks == plain.ticks and mega.stats()["compiled_ticks"] == 1
    for rid in want:
        torch.testing.assert_close(got[rid], want[rid], rtol=0, atol=0)


def test_unfused_tick_launches_b2_once_per_tick(monkeypatch):
    """The unfused tick is one per-row sampler-step call per tick."""
    _, tcfg, _, tp, _ = _models()
    eps = tdlm.make_tile_eps_fn(tp, tcfg, SLOTS, SEQ)
    calls = []
    real = step_k.sampler_step_rows_2d
    monkeypatch.setattr(step_k, "sampler_step_rows_2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = ContinuousBatchingEngine(TSCH, eps, (SEQ, LATENT), slots=SLOTS,
                                   use_mega=False, device="cpu")
    _serve(eng)
    assert len(calls) == eng.ticks > 0


ENGINE_KW = {"stochastic": dict(stochastic=True),
             "preview": dict(preview=True),
             "order2": dict(max_order=2)}


@pytest.mark.parametrize("case", list(ENGINE_KW))
def test_resolve_mega_reasons_equal_jax(case):
    jcfg, tcfg, jp, tp, _ = _models()
    kw = ENGINE_KW[case]
    teps = tdlm.make_tile_eps_fn(tp, tcfg, SLOTS, SEQ)
    jeps = jdlm.make_tile_eps_fn(jp, jcfg, SLOTS, SEQ)
    with pytest.raises(ValueError) as jerr:
        JEngine(JSCH, jeps, (SEQ, LATENT), slots=SLOTS, use_mega=True, **kw)
    with pytest.raises(ValueError) as terr:
        ContinuousBatchingEngine(TSCH, teps, (SEQ, LATENT), slots=SLOTS,
                                 use_mega=True, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "deterministic/order-1/preview-free" in str(terr.value)
    auto = ContinuousBatchingEngine(TSCH, teps, (SEQ, LATENT), slots=SLOTS,
                                    device="cpu", **kw)
    assert not auto.use_mega and auto.tick_variant != "mega"


def _meta_eps(cfg, batch, attn_impl):
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta")
    p = meta(tdlm.param_shapes(cfg))

    def eps(x2, t):
        raise AssertionError("never called")
    eps.slot_tile_aware = True
    eps.mega_spec = megastep.MegaSpec(
        params={k: p[k] for k in tdlm.EPS_PATH}, cfg=cfg, batch=batch,
        seq_len=SEQ, attn_impl=attn_impl)
    return eps


@pytest.mark.parametrize("slots,impl,ok", [(4, "exact", True),
                                           (4, "flash", True),
                                           (8, "flash", False)])
def test_resolve_mega_budget_at_smollm_width(slots, impl, ok):
    """The JAX byte model against MEGA_BUDGET decides for the smollm-width
    2-layer trunk (no weights are made: meta tensors)."""
    eps = _meta_eps(configs.DLM_SMOLLM_MEGA, slots, impl)
    shape = (SEQ, configs.DLM_SMOLLM_MEGA.latent_dim)
    eng = ContinuousBatchingEngine(TSCH, eps, shape, slots=slots,
                                   device="cpu")
    assert eng.use_mega == ok
    if not ok:
        with pytest.raises(ValueError, match="budget 39321600 B"):
            ContinuousBatchingEngine(TSCH, eps, shape, slots=slots,
                                     use_mega=True, device="cpu")


def test_resolve_mega_geometry_and_budget(monkeypatch):
    _, tcfg, _, tp, _ = _models()
    eps = tdlm.make_tile_eps_fn(tp, tcfg, SLOTS, SEQ)
    with pytest.raises(ValueError, match="geometry"):
        ContinuousBatchingEngine(TSCH, eps, (SEQ, LATENT), slots=SLOTS + 1,
                                 use_mega=True, device="cpu")
    monkeypatch.setattr(tops, "MEGA_BUDGET", 1024)
    eng = ContinuousBatchingEngine(TSCH, eps, (SEQ, LATENT), slots=SLOTS,
                                   device="cpu")
    assert not eng.use_mega and eng.tick_variant == "rows"
