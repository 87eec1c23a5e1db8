"""The port's shape table (``repro_torch.launch.shapes``) against the JAX
package's (``repro/launch/shapes.py``), for every --arch x shape id.

Exact: each arch's parameter stand-ins (``param_specs``, from the
family's shape table) against ``jax.eval_shape`` of JAX's
``init_params``, leaf for leaf in float32 and bfloat16; the resolved
combo (kind, batch, seq_len, the long_500k window policy and the
resolved config), every input stand-in's shape and dtype,
and every cache leaf's path, shape and dtype, leaf for leaf (the port's
caches are written in place, yet keep JAX's leaves: no family differs),
hence the cache's total bytes.  The port's stand-ins are meta tensors: no
storage is allocated.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import get_api as j_get_api
from repro_torch import configs
from repro_torch.launch import shapes

COMBOS = [(a, s) for a in configs.ARCH_IDS for s in shapes.SHAPE_IDS]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _sig(leaf):
    """(shape, dtype name) of a JAX ShapeDtypeStruct or a torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), str(leaf.dtype)


def test_table_is_jaxs():
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.SHAPE_IDS == jshapes.SHAPE_IDS
    assert shapes.WINDOW == jshapes.WINDOW
    assert sorted(configs.ARCH_IDS) == sorted(jconfigs.ARCH_IDS)


@pytest.mark.parametrize("arch,shape_id", COMBOS,
                         ids=[f"{a}-{s}" for a, s in COMBOS])
def test_combo_inputs_and_cache_match_jax(arch, shape_id):
    j = jshapes.resolve(jconfigs.get(arch), shape_id)
    t = shapes.resolve(configs.get(arch), shape_id)
    assert (t.shape_id, t.kind, t.batch, t.seq_len, t.windowed) == (
        j.shape_id, j.kind, j.batch, j.seq_len, j.windowed)
    assert dataclasses.asdict(t.arch) == dataclasses.asdict(j.arch)

    ji, ti = jshapes.input_specs(j), shapes.input_specs(t)
    assert sorted(ti) == sorted(ji)
    for k in ji:
        assert _sig(ti[k]) == _sig(ji[k]), k
        assert ti[k].device.type == "meta"
    if t.kind == "train":
        return
    jc = dict(_leaves(jshapes.cache_specs(j)))
    tc_tree = shapes.cache_specs(t)
    tc = dict(_leaves(tc_tree))
    assert sorted(tc) == sorted(jc)
    for path in jc:
        assert _sig(tc[path]) == _sig(jc[path]), path
        assert tc[path].device.type == "meta"
    j_bytes = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                  for v in jax.tree.leaves(jshapes.cache_specs(j)))
    assert shapes.nbytes(tc_tree) == j_bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_jax_init(arch, dtype):
    jcfg = jconfigs.get(arch)
    want = dict(_leaves(jax.eval_shape(functools.partial(
        j_get_api(jcfg).init_params, cfg=jcfg, dtype=getattr(jnp, dtype)),
        jax.random.PRNGKey(0))))
    got = dict(_leaves(shapes.param_specs(configs.get(arch),
                                          getattr(torch, dtype))))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _sig(got[path]) == _sig(want[path]), path
        assert got[path].device.type == "meta"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_dtype_follows_the_argument(dtype):
    combo = shapes.resolve(configs.get("smollm-135m"), "decode_32k")
    kv = [v for p, v in _leaves(shapes.cache_specs(combo, dtype))
          if v.is_floating_point()]
    assert kv and all(v.dtype == dtype for v in kv)


def test_input_specs_all_combos_shapes():
    """JAX's test_input_specs_all_combos_shapes on the port."""
    for arch in configs.ARCH_IDS:
        for shape_id in shapes.SHAPE_IDS:
            combo = shapes.resolve(configs.get(arch), shape_id)
            specs = shapes.input_specs(combo)
            assert "tokens" in specs
            assert specs["tokens"].shape[0] == combo.batch
            if combo.kind == "train" and combo.arch.family == "vlm":
                total = specs["tokens"].shape[1] + specs["embeds"].shape[1]
                assert total == combo.seq_len
            if combo.kind != "train":
                assert len(list(_leaves(shapes.cache_specs(combo)))) > 0


def test_long500k_policy():
    """JAX's test_long500k_policy: windowed variants only for
    full-attention families."""
    for arch in configs.ARCH_IDS:
        combo = shapes.resolve(configs.get(arch), "long_500k")
        fam = configs.get(arch).family
        if fam in ("ssm", "hybrid"):
            assert not combo.windowed, arch
        else:
            assert combo.windowed, arch
            assert combo.arch.sliding_window == shapes.WINDOW
