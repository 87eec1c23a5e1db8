"""Mesh-sharded slot pools of the port (``serving/fleet/sharded.py``'s
mesh half, the engine's ``mesh=``, the fleet's ``meshes=``) against the
JAX package's, on simulated CPU meshes.

The port's meshes are ``[torch.device("cpu")] * n`` (``launch.mesh``'s
``devices=``, its counterpart of JAX's forced host devices); the JAX
process here has one CPU device, so JAX runs its unsharded engine and its
own 1-device-mesh fleet (the bitwise anchor of ``tests/test_fleet.py``).
Both sides serve the demo trunk on bitwise-equal ``make_trunk_params``
and draw x_T from the same seeds (threefry).

Tolerances:
  * a (1, 1) mesh against the port's unsharded engine: bitwise x0 (eta 0,
    order 1), as ``tests/test_fleet.py:251``;
  * model > 1 against it: rtol 1e-5, atol 1e-5 (``tests/test_fleet.py``);
  * the port against JAX: 1e-5 of max|x|, the scheduler tolerance;
  * ``sharded_eps_from_apply`` against ``make_sharded_eps``: rtol 1e-5,
    atol 1e-6 (``tests/test_fleet.py:287``);
  * a data-split state (mid-slot split included, stochastic, order 2,
    preview, probes, a resumed request) against the unsharded engine:
    bitwise, since the step is per row and B2's noise is keyed on (row
    seed, lane);
  * ``stats()``: ``mesh``, ``state_sharded``, ``compiled_ticks`` exactly
    JAX's (its fleet's pool for (1, 1), its placement rule otherwise).
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.core import make_schedule as j_make_schedule
from repro.launch import mesh as jmesh
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.fleet import PoolFleet as JFleet
from repro.serving.fleet import make_sharded_eps as j_make_sharded_eps
from repro.serving.fleet import make_trunk_params as j_make_trunk_params
from repro.serving.fleet import make_unsharded_eps as j_make_unsharded_eps
from repro.serving.scheduler.request import SampleRequest as JReq
from repro_torch import configs, prng
from repro_torch.core import make_schedule
from repro_torch.kernels.sampler_step import ops as tile_ops
from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
from repro_torch.models import unet
from repro_torch.sampling import SamplerPlan
from repro_torch.serving import (ContinuousBatchingEngine, PoolFleet,
                                 SampleRequest, SlotCheckpoint)
from repro_torch.serving.fleet import (make_sharded_eps, make_trunk_params,
                                       make_unsharded_eps,
                                       sharded_eps_from_apply, trunk_apply)
from repro_torch.sharding import P

ENGINE_TOL_OF_SCALE = 1e-5
T, DIM, HIDDEN, SLOTS, N_REQ = 100, 16, 64, 4, 6
CPU = [torch.device("cpu")] * 8
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
SCH, JSCH = make_schedule("linear", T), j_make_schedule("linear", T=T)
PARAMS = make_trunk_params(SCH, DIM, HIDDEN, device="cpu")


def _reqs(n=N_REQ, R=SampleRequest, **kw):
    return [R(request_id=i, S=4 + (i % 3) * 3, eta=0.0, seed=i, **kw)
            for i in range(n)]


def _x0(results):
    return {r.request_id: np.asarray(r.x0) for r in results}


def _mesh(dims):
    d, m = dims
    return make_host_mesh(model=m, devices=CPU[:d * m])


def _jax_rule(dims, slots=SLOTS):
    """JAX's engine rule: rows split over the data axes iff > 1 and
    dividing the rows (``repro/serving/scheduler/engine.py:343``)."""
    rows = slots * tile_ops.slot_rows((DIM,))
    return dims[0] > 1 and rows % dims[0] == 0


@pytest.fixture(scope="module")
def runs():
    """JAX's unsharded engine, JAX's 1-device-mesh fleet and the port's
    unsharded engine, each serving the same requests once (plus JAX's
    engine on the fleet test's affinity-keyed list)."""
    jp = j_make_trunk_params(JSCH, DIM, HIDDEN)
    for k in ("wq", "wo", "time_w"):
        assert np.array_equal(np.asarray(jp["trunk"][k]),
                              PARAMS["trunk"][k].numpy()), k
    jeng = JEngine(JSCH, j_make_unsharded_eps(jp), (DIM,), SLOTS)
    j_ref = _x0(jeng.serve(_reqs(R=JReq)))
    j_keyed = _x0(jeng.serve(_keyed(JReq)))
    one = jmesh.make_fleet_mesh(len(jax.devices()), model=1)[0]
    jfleet = JFleet.build(JSCH, lambda pool_id, m: j_make_sharded_eps(m, jp),
                          (DIM,), n_pools=1, slots=SLOTS, meshes=[one])
    j_fleet = _x0(jfleet.serve(_reqs(R=JReq), now=0.0))
    tref = ContinuousBatchingEngine(SCH, make_unsharded_eps(PARAMS),
                                    (DIM,), SLOTS, device="cpu")
    return {"jax": j_ref, "jax_keyed": j_keyed, "jax_fleet": j_fleet,
            "jax_pool_stats": jfleet.stats()["pools"][0],
            "port": _x0(tref.serve(_reqs()))}


def _keyed(R=SampleRequest):
    return [R(request_id=i, S=4 + (i % 3) * 3, eta=0.0, seed=i,
              affinity_key=i % 5) for i in range(10)]


def _close_to_jax(got, want):
    for rid, w in want.items():
        scale = max(float(np.abs(w).max()), 1.0)
        assert np.abs(got[rid] - w).max() <= ENGINE_TOL_OF_SCALE * scale, rid


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_mesh_engine_matches_unsharded_and_jax(runs, dims, monkeypatch):
    """x0 against the port's unsharded engine and JAX's; the per-row step
    runs once per data shard a tick; JAX's stats."""
    from repro_torch.kernels.sampler_step import kernel as step_k
    calls = []
    real = step_k.sampler_step_rows_2d
    monkeypatch.setattr(step_k, "sampler_step_rows_2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = _mesh(dims)
    eng = ContinuousBatchingEngine(SCH, make_sharded_eps(mesh, PARAMS),
                                   (DIM,), SLOTS, mesh=mesh, pool_id=0,
                                   device="cpu")
    got = _x0(eng.serve(_reqs()))
    assert len(calls) == eng.ticks * len(eng._blocks) > 0
    ref = runs["port"]
    for rid in ref:
        if dims == (1, 1):
            assert np.array_equal(got[rid], ref[rid]), rid
        else:
            np.testing.assert_allclose(got[rid], ref[rid], rtol=1e-5,
                                       atol=1e-5)
    _close_to_jax(got, runs["jax"])
    _close_to_jax(got, runs["jax_fleet"])
    st = eng.stats()
    assert st["mesh"] == {"data": dims[0], "model": dims[1]}
    assert st["compiled_ticks"] == 1
    assert st["state_sharded"] == _jax_rule(dims)
    assert len(eng._x2) == (dims[0] if st["state_sharded"] else 1)
    if dims == (1, 1):
        js = runs["jax_pool_stats"]
        assert (st["mesh"], st["state_sharded"], st["compiled_ticks"]) == (
            js["mesh"], js["state_sharded"], js["compiled_ticks"])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_mesh_fleet_matches_jax(runs, dims):
    """2 pools on disjoint meshes (``make_fleet_mesh``), factory eps placed
    per pool: mixed-S, affinity-keyed load completes, each request's x0
    is JAX's, every pool one tick function with JAX's mesh stats."""
    d, m = dims
    meshes = make_fleet_mesh(2, model=m, devices=CPU[:2 * d * m])
    seen = {}

    def factory(pool_id, mesh):
        seen[pool_id] = mesh
        return make_sharded_eps(mesh, PARAMS)
    fleet = PoolFleet.build(SCH, factory, (DIM,), n_pools=2, slots=SLOTS,
                            meshes=meshes, device="cpu")
    res = fleet.serve(_keyed(), now=0.0)
    assert len(res) == 10 and not any(r.dropped for r in res)
    assert seen == {0: meshes[0], 1: meshes[1]}
    _close_to_jax(_x0(res), runs["jax_keyed"])
    for ps in fleet.stats()["pools"]:
        assert ps["compiled_ticks"] == 1
        assert ps["mesh"] == {"data": d, "model": m}
        assert ps["state_sharded"] == _jax_rule(dims)


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (2, 2)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_gspmd_wrapper_matches_shard_map_trunk(dims):
    mesh = _mesh(dims)
    auto = sharded_eps_from_apply(mesh, PARAMS, trunk_apply)
    explicit = make_sharded_eps(mesh, PARAMS)
    assert auto.mesh is explicit.mesh is mesh
    assert explicit.params["trunk"]["wq"].sharding.spec == P(None, "model")
    x = prng.normal(prng.PRNGKey(3, "cpu"), (8, DIM))
    t = torch.full((8,), 37, dtype=torch.int32)
    got, want = auto(x, t), explicit(x, t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    if dims == (1, 1):
        assert torch.equal(want, trunk_apply(PARAMS, x, t))


def test_mid_slot_split_is_bitwise_the_unsharded_engine():
    """3 slots of 16 rows on a (2, 1) mesh: 24-row blocks, so slot 1
    straddles both.  Stochastic, order 2, preview and probes, one request
    resumed from a checkpoint (written across the blocks) and one slot
    snapshotted across them: everything bitwise the unsharded engine."""
    shape = (3072,)                       # 12 rows, a 16-row slot
    params = make_trunk_params(SCH, shape[0], 32, device="cpu")
    mesh = _mesh((2, 1))
    rows = tile_ops.to_slot_tile_layout(
        prng.normal(prng.PRNGKey(9, "cpu"), (1,) + shape))[0]

    def requests():
        previews = []
        out = [SampleRequest(request_id=i, S=5 + i, eta=1.0 if i % 2 else 0.0,
                             seed=20 + i, preview_every=2,
                             on_preview=lambda rid, k, x0: previews.append(
                                 (rid, k, x0)))
               for i in range(5)]
        out[1].resume = SlotCheckpoint(request_id=1, k=0, x_rows=rows,
                                       hist_rows=None)
        out[4] = SampleRequest(request_id=4, seed=24,
                               plan=SamplerPlan.build(SCH, 6, order=2))
        return out, previews

    def run(eps, **kw):
        eng = ContinuousBatchingEngine(
            SCH, eps, shape, 3, stochastic=True, max_order=2,
            preview=True, probes=True, device="cpu", **kw)
        reqs, previews = requests()
        for r in reqs:
            eng.submit(r, now=0.0)
        res = eng.run(max_ticks=2, now_fn=lambda: 0.0)
        snap = eng.snapshot_slot(1, now=0.0)
        res += eng.run(now_fn=lambda: 0.0)
        return eng, res, previews, snap

    base, rb, pb, sb = run(make_unsharded_eps(params))
    eng, rm, pm, sm = run(sharded_eps_from_apply(mesh, params, trunk_apply),
                          mesh=mesh)
    assert eng.stats()["state_sharded"] and [
        (lo, hi) for lo, hi, _ in eng._blocks] == [(0, 24), (24, 48)]
    assert sorted(r.request_id for r in rm) == list(range(5))
    xb, xm = _x0(rb), _x0(rm)
    for rid in xb:
        assert np.array_equal(xm[rid], xb[rid]), rid
    assert [(a, b) for a, b, _ in pm] == [(a, b) for a, b, _ in pb]
    assert all(torch.equal(a, b) for (_, _, a), (_, _, b) in zip(pm, pb))
    assert torch.equal(sm.x_rows, sb.x_rows)
    assert torch.equal(sm.hist_rows, sb.hist_rows)
    assert eng.last_frame["values"] == base.last_frame["values"]
    assert {r.request_id: r.quality for r in rm} == {
        r.request_id: r.quality for r in rb}
    assert eng.stats()["compiled_ticks"] == base.stats()["compiled_ticks"]


def test_toy_unet_under_sharded_eps_from_apply():
    """TOY_UNET, weights placed by the rules and gathered per data block,
    on a (2, 1) mesh: one U-Net call per block of one slot, x0 within
    1e-5 of the unsharded engine's."""
    model = unet.init_params(prng.PRNGKey(0, "cpu"), configs.TOY_UNET,
                             device="cpu").eval()
    shape = (16, 16, 3)
    mesh = _mesh((2, 1))
    calls = []

    def apply(p, x, t):
        calls.append(x.shape[0])
        with torch.no_grad():
            return functional_call(model, p, (x, t))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    eps = sharded_eps_from_apply(mesh, state, apply)
    eng = ContinuousBatchingEngine(SCH, eps, shape, 2, mesh=mesh,
                                   device="cpu")
    ref = ContinuousBatchingEngine(SCH, unet.make_eps_fn(model), shape, 2,
                                   device="cpu")
    reqs = [SampleRequest(request_id=i, S=3, seed=i) for i in range(2)]
    got, want = _x0(eng.serve(reqs)), _x0(ref.serve(reqs))
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], rtol=1e-5,
                                   atol=1e-5)
    assert calls == [1, 1] * 3 and eng.stats()["state_sharded"]


@pytest.mark.parametrize("dims", [(2, 1), (2, 2)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_block_eps_path_with_probes_and_history(dims):
    """Whole slots per data block and ``make_sharded_eps`` on the same
    mesh: eps runs per block (``apply_blocks``, one call per data block).
    Stochastic, order 2, preview and probes against the unsharded engine:
    x0, previews and probe frames within rtol / atol 1e-5."""
    mesh = _mesh(dims)
    eps = make_sharded_eps(mesh, PARAMS)
    calls = []
    blocks = eps.apply_blocks

    def counted(xs, ts):
        calls.append([x.shape[0] for x in xs])
        return blocks(xs, ts)
    eps.apply_blocks = counted

    def run(eps_fn, **kw):
        eng = ContinuousBatchingEngine(
            SCH, eps_fn, (DIM,), SLOTS, stochastic=True, max_order=2,
            preview=True, probes=True, device="cpu", **kw)
        previews = []
        reqs = [SampleRequest(request_id=i, S=5, seed=i,
                              eta=float(i % 2), preview_every=2,
                              on_preview=lambda rid, k, x0: previews.append(
                                  x0)) for i in range(SLOTS)]
        reqs[0] = SampleRequest(request_id=0, seed=0,
                                plan=SamplerPlan.build(SCH, 5, order=2))
        return eng, _x0(eng.serve(reqs)), previews

    base, xb, pb = run(make_unsharded_eps(PARAMS))
    eng, xm, pm = run(eps, mesh=mesh)
    assert calls and all(c == [SLOTS // 2] * 2 for c in calls)
    for rid in xb:
        np.testing.assert_allclose(xm[rid], xb[rid], rtol=1e-5, atol=1e-5)
    assert len(pm) == len(pb)
    for a, b in zip(pm, pb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(eng.last_frame["values"],
                               base.last_frame["values"], rtol=1e-5,
                               atol=1e-5)
    assert eng.stats()["state_sharded"]


@pytest.mark.parametrize("use_mega", [None, False], ids=["mega", "rows"])
def test_mega_and_slot_tile_eps_on_a_mesh(use_mega, monkeypatch):
    """A mega-eligible diffusion-LM trunk (``make_tile_eps_fn``, slot-tile
    aware) with ``mesh=``: the mega tick is taken by JAX's rule (the eps
    model's ``mega_spec``) and runs on the gathered state; ``use_mega=
    False`` evaluates the trunk on the gathered state and then launches
    the per-row step once per data block (3 a tick).  Both bitwise the
    unsharded mega engine."""
    from repro_torch.diffusion_lm import model as tdlm
    from repro_torch.kernels.sampler_step import kernel as step_k
    from repro_torch.models.common import ArchConfig
    slots, seq, latent = 3, 64, 32
    cfg = tdlm.DiffusionLMConfig(arch=ArchConfig(
        name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=50), time_dim=32)
    params = tdlm.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    eps = tdlm.make_tile_eps_fn(params, cfg, slots, seq)
    sch = make_schedule("linear", 1000)
    calls = []
    real = step_k.sampler_step_rows_2d
    monkeypatch.setattr(step_k, "sampler_step_rows_2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = _mesh((3, 1))
    eng = ContinuousBatchingEngine(sch, eps, (seq, latent), slots,
                                   use_mega=use_mega, mesh=mesh,
                                   device="cpu")
    ref = ContinuousBatchingEngine(sch, eps, (seq, latent), slots,
                                   device="cpu")
    assert eng.stats()["mega_tick"] is (use_mega is None)
    assert ref.stats()["mega_tick"] and eng.stats()["state_sharded"]

    def serve(e):
        return _x0(e.serve([SampleRequest(request_id=i, S=s, seed=i)
                            for i, s in enumerate([3, 5, 2, 4])]))
    got = serve(eng)
    assert len(calls) == (0 if use_mega is None else 3 * eng.ticks)
    want = serve(ref)
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


# ------------------------------------------------- launch/serve.py --pools
@pytest.mark.parametrize("n_dev,pools", [(4, 2), (8, 2), (8, 4), (3, 2),
                                         (6, 4), (8, 3), (1, 2)],
                         ids=lambda v: str(v))
def test_serve_pool_meshes_follow_jaxs_rule(n_dev, pools, monkeypatch):
    """``pool_meshes`` gives each pool a (n_dev / pools, 1) mesh exactly
    when JAX's ``serve.py`` does (``n_dev >= 2 * pools`` and ``pools``
    dividing ``n_dev``), else None; never on a CPU service."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve
    real = tmesh.make_fleet_mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_dev)
    monkeypatch.setattr(tmesh, "make_fleet_mesh",
                        lambda p: real(p, devices=[CPU[0]] * n_dev))
    got = serve.pool_meshes(pools, torch.device("cuda"))
    if n_dev >= 2 * pools and n_dev % pools == 0:
        assert [m.shape for m in got] == [
            {"data": n_dev // pools, "model": 1}] * pools
    else:
        assert got is None
    assert serve.pool_meshes(pools, torch.device("cpu")) is None


def test_serve_fleet_on_pool_meshes_matches_one_device(tmp_path,
                                                       monkeypatch):
    """``--scheduler --pools 2`` on TOY_UNET with four (simulated) cards:
    each pool serves on its own (2, 1) mesh through ``_mesh_eps`` and the
    fleet is built with ``device=None``; the saved x0 stay within the
    scheduler tolerance of the one-device fleet's."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve
    argv = ["--arch", "unet", "--device", "cpu", "--scheduler", "--pools",
            "2", "--slots", "2", "--s-mix", "3,4", "--n-samples", "4"]
    serve.main(argv + ["--out", str(tmp_path / "one.npy")])
    real_mesh, real_rule = tmesh.make_fleet_mesh, serve.pool_meshes
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "make_fleet_mesh",
                        lambda p: real_mesh(p, devices=CPU[:4]))
    monkeypatch.setattr(serve, "pool_meshes", lambda pools, device:
                        real_rule(pools, torch.device("cuda")))
    servers = []
    real_finish = serve._finish_replay
    monkeypatch.setattr(serve, "_finish_replay", lambda res, server, *a:
                        servers.append(server) or real_finish(res, server,
                                                              *a))
    serve.main(argv + ["--out", str(tmp_path / "mesh.npy")])
    assert [p.engine.stats()["mesh"] for p in servers[0].pools] == [
        {"data": 2, "model": 1}] * 2
    assert all(p.engine.stats()["state_sharded"] for p in servers[0].pools)
    want = np.load(tmp_path / "one.npy")
    got = np.load(tmp_path / "mesh.npy")
    assert got.shape == want.shape == (4, 16, 16, 3)
    assert np.abs(got - want).max() <= (ENGINE_TOL_OF_SCALE
                                        * np.abs(want).max())
