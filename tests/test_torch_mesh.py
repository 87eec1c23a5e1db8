"""The port's meshes (``repro_torch.launch.mesh``), sharding rules
(``repro_torch.sharding``) and sharding flags (``models.runtime_flags``)
against the JAX package's (``repro/launch/mesh.py``,
``repro/sharding/rules.py``, ``repro/models/runtime_flags.py``).

Meshes are simulated as JAX's tests simulate them: the port by passing
``devices=[torch.device("cpu")] * n``, JAX's rule functions by a stand-in
object whose ``shape`` is the mesh's ``{axis: size}`` dict (they read
nothing else), so no JAX device is needed.

Exact: mesh shapes and the JAX ``ValueError`` texts; every partition spec
of ``spec_for_param``, ``batch_spec`` and ``spec_for_cache`` for every
leaf of all ten --arch ids at full width (``launch.shapes.param_specs`` /
``input_specs`` / ``cache_specs``, meta tensors) on the mesh shapes (1,
1), (2, 2), (1, 8), (16, 16) and (2, 16, 16); the rule coverage of every
leaf; ``NamedSharding``'s blocks and the tensor they join back to.
"""
import numpy as np
import pytest
import torch

from repro import sharding as jsharding
from repro.models import runtime_flags as jflags
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import shapes
from repro_torch.launch.mesh import (Mesh, make_fleet_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.runtime_flags import (FLAGS, constrain,
                                              constrain_residual, perf_flags)
from repro_torch.sharding import (P, NamedSharding, batch_spec, data_axes,
                                  device_put, replicate_allowed, replicated,
                                  rule_for, shard_batch, shard_cache,
                                  shard_params, spec_for_cache,
                                  spec_for_param)
from repro_torch.sharding.rules import tree_map_with_path

CPU = [torch.device("cpu")] * 8
MESH_SHAPES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
               (1, 8): ("data", "model"), (16, 16): ("data", "model"),
               (2, 16, 16): ("pod", "data", "model")}


class _StandIn:
    """What JAX's rule functions read of a mesh: its shape dict."""

    def __init__(self, shape):
        self.shape = shape


def _meshes():
    out = []
    for dims, axes in MESH_SHAPES.items():
        devs = np.empty(dims, dtype=object)
        devs.ravel()[:] = [torch.device("meta")] * devs.size
        mesh = Mesh(devs, axes)
        out.append((mesh, _StandIn(dict(mesh.shape))))
    return out


def _paths(tree):
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, tuple(leaf.shape))),
                       tree)
    return out


# ------------------------------------------------------------------ meshes
def test_meshes_over_explicit_devices():
    m = make_host_mesh(model=2, devices=CPU)
    assert m.shape == {"data": 4, "model": 2} and m.axis_names == (
        "data", "model")
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    pools = make_fleet_mesh(2, model=2, devices=[f"cpu:{i}"
                                                 for i in range(8)])
    assert [p.shape for p in pools] == [{"data": 2, "model": 2}] * 2
    seen = [str(d) for p in pools for d in p.devices.ravel()]
    assert len(set(seen)) == 8              # disjoint, covers every device
    assert [c for row in pools[0].data_model_grid() for c in row] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(prod) == ("pod", "data")
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_fleet_mesh(1, devices=CPU[:1])[0].shape == {"data": 1,
                                                            "model": 1}


def test_mesh_errors_are_jaxs():
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_host_mesh(model=3, devices=CPU)
    with pytest.raises(ValueError, match="not divisible by n_pools=3"):
        make_fleet_mesh(3, devices=CPU)
    with pytest.raises(ValueError, match=r"per-pool device count 4 \(= 8 "
                       r"devices / 2 pools\) is not divisible by model=3"):
        make_fleet_mesh(2, model=3, devices=CPU)


def test_mesh_of_the_cards_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_host_mesh, lambda: make_fleet_mesh(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_host_mesh()
    assert [str(d) for d in m.devices.ravel()] == ["cuda:0", "cuda:1"]


# ------------------------------------------------------------------- rules
def test_rule_table_is_jaxs():
    from repro_torch.sharding import rules
    assert rules._RULES == jrules._RULES
    assert rules.REPLICATE_OK == jrules.REPLICATE_OK
    assert rule_for("layers/moe/w_gate") == r"/moe/w_gate$"
    assert rule_for("layers/w_gate") == r"/w_gate$"
    one = make_host_mesh(devices=CPU[:1])
    assert spec_for_param("layers/moe/w_up", (4, 8, 16, 32), one) == P(
        None, "model", None, None)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_jaxs_at_full_width(arch):
    """spec_for_param / batch_spec / spec_for_cache of the port and of
    JAX on the same (path, shape) pairs: every leaf of the arch's
    full-width params, every input and every cache leaf of each shape id,
    on the five mesh shapes.  Also the coverage rule: no leaf falls
    through to replicated without a rule or an allowlist entry."""
    cfg = configs.get(arch)
    params = _paths(shapes.param_specs(cfg))
    orphans = [p for p, _ in params
               if rule_for(p) is None and not replicate_allowed(p)]
    assert not orphans, f"{arch}: no rule and not on REPLICATE_OK: {orphans}"
    assert [rule_for(p) for p, _ in params] == [jrules.rule_for(p)
                                                for p, _ in params]
    combos = [shapes.resolve(cfg, s) for s in shapes.SHAPE_IDS]
    caches = [(c.batch, _paths(shapes.cache_specs(c))) for c in combos]
    inputs = [(c.batch, _paths(shapes.input_specs(c))) for c in combos]
    for mesh, jmesh in _meshes():
        for p, shape in params:
            assert tuple(spec_for_param(p, shape, mesh)) == tuple(
                jsharding.spec_for_param(p, shape, jmesh)), (p, mesh.shape)
        for batch, leaves in caches:
            for p, shape in leaves:
                assert tuple(spec_for_cache(p, shape, mesh, batch)) == tuple(
                    jsharding.spec_for_cache(p, shape, jmesh, batch)), (
                        p, shape, mesh.shape)
        for _, leaves in inputs:
            for p, shape in leaves:
                assert tuple(batch_spec(mesh, shape[0], len(shape))) == \
                    tuple(jsharding.batch_spec(jmesh, shape[0], len(shape)))


# ---------------------------------------------------------------- placement
def test_named_sharding_blocks_and_join():
    """Device (i, j) of a (2, 2) mesh holds row block i and column block
    j under P("data", "model"), the whole tensor under P(); the blocks
    join back to the tensor bitwise; a spec naming an absent axis
    raises."""
    mesh = make_host_mesh(model=2, devices=CPU[:4])
    x = torch.arange(48.0).reshape(4, 12)
    for spec, want in ((P("data", "model"), lambda i, j: x[2 * i:2 * i + 2,
                                                           6 * j:6 * j + 6]),
                       (P(None, "model"), lambda i, j: x[:, 6 * j:6 * j + 6]),
                       (P(), lambda i, j: x)):
        sh = NamedSharding(mesh, spec)
        blocks = sh.split(x)
        for i in range(2):
            for j in range(2):
                assert torch.equal(blocks[i, j], want(i, j))
        assert torch.equal(sh.join(blocks, x.shape, "cpu"), x)
    prod = make_production_mesh(multi_pod=True)
    y = torch.empty((64, 3), device="meta")
    st = NamedSharding(prod, batch_spec(prod, 64, 2))
    assert st.index((1, 3, 5), y.shape) == (slice(38, 40), slice(0, 3))
    with pytest.raises(ValueError, match="lacks"):
        NamedSharding(mesh, P("pod", None))


def test_shard_params_places_the_trunk_as_jax_does():
    mesh = make_host_mesh(model=2, devices=CPU[:4])
    params = {"trunk": {"wq": torch.randn(8, 16), "wo": torch.randn(16, 8),
                        "time_w": torch.ones(1)},
              "alpha_bar": torch.rand(10)}
    sh = shard_params(params, mesh)
    assert sh["trunk"]["wq"].spec == P(None, "model")
    assert sh["trunk"]["wo"].spec == P("model", None)
    assert sh["trunk"]["time_w"].spec == P()
    assert sh["alpha_bar"].spec == P(None)
    placed = device_put(params, sh)
    assert torch.equal(placed["trunk"]["wq"].local((1, 1)),
                       params["trunk"]["wq"][:, 8:])
    assert torch.equal(placed["trunk"]["wo"].gather("cpu"),
                       params["trunk"]["wo"])
    cache = {"k": torch.empty((3, 4, 8, 2, 5), device="meta"),
             "idx": torch.empty((), device="meta")}
    assert {k: v.spec for k, v in shard_cache(cache, mesh, 4).items()} == {
        "k": spec_for_cache("k", (3, 4, 8, 2, 5), mesh, 4), "idx": P()}
    assert shard_batch({"x": torch.empty((6, 3), device="meta")},
                       mesh)["x"].spec == P("data", None)
    assert replicated(mesh).is_replicated


# ------------------------------------------------------------------- flags
def test_runtime_flags_fields_and_constrain():
    """JAX's flag fields and defaults but decode_inplace and accum_steps,
    which the port refuses; constrain returns x itself, with or without a
    mesh, and raises on an axis the mesh lacks."""
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(FLAGS)] == [
        (f.name, f.default) for f in dataclasses.fields(jflags.PerfFlags)
        if f.name not in ("decode_inplace", "accum_steps")]
    for name in ("decode_inplace", "accum_steps"):
        with pytest.raises(AttributeError, match=name):
            with perf_flags(**{name: 1}):
                pass
    x = torch.randn(2, 6, 4)
    assert constrain(x, P("data", "model")) is x      # no mesh: a no-op
    mesh = make_host_mesh(model=2, devices=CPU[:4])
    with perf_flags(mesh=mesh, seq_parallel_spec=P(None, "model")):
        assert FLAGS.mesh is mesh
        assert constrain_residual(x) is x
        assert constrain(x, P(("data",), None, "model")) is x
        with pytest.raises(ValueError, match="lacks"):
            constrain(x, P("pod"))
    assert FLAGS.mesh is None and FLAGS.seq_parallel_spec is None
