"""The fleet's demo trunk (``repro_torch.serving.fleet.sharded``)
against the JAX package's (``repro/serving/fleet/sharded.py``).

Tolerances:
  * ``make_trunk_params``: bitwise (the same threefry draws, the same
    float32 scaling) for seeds 0-3.
  * ``trunk_apply`` / ``make_unsharded_eps``: within 4 float32 ulps of
    max(|eps|) on the same weights, x and t (tanh and the two products
    round differently in XLA and PyTorch).
  * The mesh entry points on a simulated (1, 2) CPU mesh: the same 4
    ulps (``tests/test_torch_sharded_mesh.py`` holds them further).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import make_schedule as j_make_schedule
from repro.serving.fleet import make_trunk_params as j_make_trunk_params
from repro.serving.fleet import make_unsharded_eps as j_make_unsharded_eps
from repro.serving.fleet import trunk_apply as j_trunk_apply
from repro_torch.core import make_schedule
from repro_torch.serving import fleet
from repro_torch.serving.fleet import (make_sharded_eps, make_trunk_params,
                                       make_unsharded_eps,
                                       sharded_eps_from_apply, trunk_apply)

F32_ULP = 2.0 ** -23
DIM, HIDDEN, T = 8, 64, 1000


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_trunk_params_bitwise(seed):
    j = j_make_trunk_params(j_make_schedule("linear", T), DIM, HIDDEN,
                            seed=seed)
    t = make_trunk_params(make_schedule("linear", T), DIM, HIDDEN,
                          seed=seed, device="cpu")
    jl, tl = dict(_leaves(j)), dict(_leaves(t))
    assert sorted(jl) == sorted(tl)
    for name, leaf in jl.items():
        got = tl[name].numpy()
        assert got.dtype == np.float32 and got.shape == leaf.shape, name
        assert np.array_equal(got, np.asarray(leaf)), name


@pytest.mark.parametrize("batch", [1, 16])
def test_trunk_apply_matches_jax(batch):
    j = j_make_trunk_params(j_make_schedule("linear", T), DIM, HIDDEN,
                            seed=1)
    t = make_trunk_params(make_schedule("linear", T), DIM, HIDDEN, seed=1,
                          device="cpu")
    rs = np.random.RandomState(batch)
    x = rs.randn(batch, DIM).astype(np.float32)
    tt = rs.randint(0, T + 1, size=batch).astype(np.int32)
    want = np.asarray(j_trunk_apply(j, jnp.asarray(x), jnp.asarray(tt)))
    got = trunk_apply(t, torch.from_numpy(x), torch.from_numpy(tt)).numpy()
    tol = 4 * F32_ULP * max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() <= tol
    got2 = make_unsharded_eps(t)(torch.from_numpy(x), torch.from_numpy(tt))
    want2 = np.asarray(j_make_unsharded_eps(j)(jnp.asarray(x),
                                               jnp.asarray(tt)))
    assert np.abs(got2.numpy() - want2).max() <= tol


@pytest.mark.parametrize("entry", ["trunk_apply_model_axis",
                                   "make_sharded_eps",
                                   "sharded_eps_from_apply"])
def test_mesh_entry_points_need_a_second_gpu(entry):
    """The mesh entry points on a simulated (1, 2) CPU mesh (no second
    card): the model-axis partial products sum to JAX's apply within 4
    float32 ulps of max(|eps|); both mesh wrappers equal it the same way,
    with their weights placed by the rules."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import P
    sch = make_schedule("linear", T)
    params = make_trunk_params(sch, DIM, HIDDEN, seed=2, device="cpu")
    j = j_make_trunk_params(j_make_schedule("linear", T), DIM, HIDDEN,
                            seed=2)
    rs = np.random.RandomState(5)
    x = rs.randn(4, DIM).astype(np.float32)
    tt = rs.randint(0, T + 1, size=4).astype(np.int32)
    want = np.asarray(j_trunk_apply(j, jnp.asarray(x), jnp.asarray(tt)))
    xt, t = torch.from_numpy(x), torch.from_numpy(tt)
    mesh = make_host_mesh(model=2, devices=[torch.device("cpu")] * 2)
    if entry == "trunk_apply_model_axis":
        half = HIDDEN // 2
        r = sum(trunk_apply({"trunk": {"wq": params["trunk"]["wq"][
            :, k * half:(k + 1) * half], "wo": params["trunk"]["wo"][
                k * half:(k + 1) * half]}}, xt, t, model_axis="model")
            for k in range(2))
        a = params["alpha_bar"][t.long()][:, None]
        got = (xt * torch.sqrt(1 - a) / (1 - a + a * 0.25)
               + 0.05 * torch.sqrt(1 - a) * params["trunk"]["time_w"] * r)
    else:
        eps = (make_sharded_eps(mesh, params) if entry == "make_sharded_eps"
               else sharded_eps_from_apply(mesh, params, trunk_apply))
        assert eps.mesh is mesh
        assert eps.params["trunk"]["wo"].sharding.spec == P("model", None)
        got = eps(xt, t)
    tol = 4 * F32_ULP * max(float(np.abs(want).max()), 1.0)
    assert np.abs(got.numpy() - want).max() <= tol


def test_fleet_exports_the_demo_trunk():
    for name in ("make_trunk_params", "trunk_apply", "make_unsharded_eps",
                 "make_sharded_eps", "sharded_eps_from_apply"):
        assert name in fleet.__all__ and hasattr(fleet, name)


def test_make_trunk_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_trunk_params(make_schedule("linear", 10), DIM, HIDDEN)
