"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro/launch/dryrun.py``) on the CPU.  Nothing here compiles
JAX's 512-device programs, and no count runs at full size.

Exact: ``n_params`` and ``n_active`` against JAX's ``active_params`` on
JAX's bfloat16 parameter shapes for all ten --arch ids; every arch x
shape id's per-device argument bytes on (16, 16) and (2, 16, 16) against
the sum of block bytes under JAX's ``spec_for_param`` / ``batch_spec`` /
``spec_for_cache`` (JAX's rule functions read only ``mesh.shape``, so a
stand-in object carries it; the port's threefry key is 16 bytes where
JAX's is 8); the collective estimate of smollm-135m's ``decode_32k`` and
``train_4k`` on (16, 16) and of the kimi-k2 smoke config's ``decode_32k``
on (2, 2), worked out by hand from the configs; rwkv6's extension
(prefill: a line, train: a parabola) against a direct count at a further
length (smoke config).  Bounded: one device's bytes of a smoke decode on
(16, 16) reach its block of the weights.  The CLI's
record keys against the keys JAX's ``run_combo`` writes (read from its
source), with and without the count; ``--opt`` sets the levers, every
hint resolves against the production mesh, and the flags come back.

JAX's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices on
import: it is imported only after ``jax.devices()`` has started the
backend, and the variable is restored after, so no other test of the
worker sees it.
"""
import ast
import dataclasses
import functools
import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.launch import shapes as jshp
from repro.models import get_api as jget_api
from repro.sharding import rules as jrules
from repro.training import optim as jopt
from repro_torch import configs, prng
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import runtime_flags

JAX_DRYRUN = Path(jrules.__file__).parents[1] / "launch" / "dryrun.py"


@pytest.fixture(scope="module")
def jdry():
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


@pytest.fixture(scope="module")
def jparams():
    """JAX's bfloat16 parameter shapes of every --arch id (eval_shape)."""
    out = {}
    for a in configs.ARCH_IDS:
        cfg = jconfigs.get(a)
        out[a] = jax.eval_shape(functools.partial(
            jget_api(cfg).init_params, cfg=cfg, dtype=jnp.bfloat16),
            jax.random.PRNGKey(0))
    return out


class _StandIn:
    """What JAX's rule functions read of a mesh: its shape dict."""

    def __init__(self, shape):
        self.shape = shape


def _jax_bytes(tree, spec_of, mesh) -> int:
    """Sum over JAX leaves of the block bytes under ``spec_of(path,
    shape)``."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(spec_of(jrules._path_str(path), leaf.shape))
        n = 1
        for d, dim in enumerate(leaf.shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= dim // math.prod(mesh.shape[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_n_params_and_n_active_are_jaxs(arch, jdry, jparams):
    rec = dryrun.run_combo(arch, "decode_32k", False, count_=False)
    cfg = jconfigs.get(arch)
    assert rec["n_params"] == jdry._count(jparams[arch])
    assert rec["n_active"] == jdry.active_params(jparams[arch], cfg)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                         "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_argument_bytes_are_jaxs_blocks(arch, multi_pod, jdry, jparams):
    mesh = make_production_mesh(multi_pod=multi_pod)
    jm = _StandIn(dict(mesh.shape))
    jp = jparams[arch]
    p_bytes = _jax_bytes(jp, lambda p, s: jrules.spec_for_param(p, s, jm),
                         jm)
    key = prng.PRNGKey(0, "meta")
    for sid in shp.SHAPE_IDS:
        jcombo = jshp.resolve(jconfigs.get(arch), sid)
        inputs = jshp.input_specs(jcombo, jnp.bfloat16)
        want = p_bytes + _jax_bytes(
            inputs, lambda p, s: jrules.batch_spec(jm, s[0], len(s)), jm)
        if jcombo.kind == "train":
            n = jdry._count(jp)
            init = (jopt.adafactor_init if n > jdry.ADAFACTOR_THRESHOLD
                    else jopt.adamw_init)
            want += _jax_bytes(jax.eval_shape(init, jp),
                               lambda p, s: jrules.spec_for_param(p, s, jm),
                               jm) + key.numel() * key.element_size()
        else:
            want += _jax_bytes(
                jshp.cache_specs(jcombo, jnp.bfloat16),
                lambda p, s: jrules.spec_for_cache(p, s, jm, jcombo.batch),
                jm)
        b = dryrun.build(shp.resolve(configs.get(arch), sid), mesh)
        assert b.argument_bytes == want, sid


def _mesh(data, model):
    devs = np.empty((data, model), dtype=object)
    devs.ravel()[:] = [torch.device("meta")] * devs.size
    return Mesh(devs, ("data", "model"))


def _estimate(cfg, sid, mesh):
    combo = shp.resolve(cfg, sid)
    b = dryrun.build(combo, mesh)
    return dryrun.lm_collective_bytes(combo, mesh, b.params, b.inputs)


def _colls(**kinds):
    n = kinds.pop("count")
    return {**{k: 0 for k in roofline.COLLECTIVES},
            **{k.replace("_", "-"): v for k, v in kinds.items()}, "count": n}


def test_lm_estimate_smollm_by_hand():
    """smollm-135m (30 layers, d 576, d_ff 1536, vocab 49152, tied
    embeddings; bfloat16) on (16, 16): wo and w_down split on their
    contracted dim, the vocab-split embed."""
    cfg = configs.get("smollm-135m")
    L, d, F, V = 30, 576, 1536, 49152
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (L, d, F, V)
    mesh = make_production_mesh()
    # decode_32k: batch 128 over 16 -> 8 rows, one token each
    per = 8 * 1 * d * 2
    assert _estimate(cfg, "decode_32k", mesh) == _colls(
        all_reduce=(L + L + 1) * per, count=L + L + 1)
    # train_4k: batch 256 over 16 -> 16 rows of 4096 tokens, forward and
    # backward; then every gradient block over the data axis
    per = 16 * 4096 * d * 2
    hq, hkv = cfg.n_heads * cfg.hd(), cfg.n_kv_heads * cfg.hd()
    grads = 2 * ((V // 16) * d + d                      # embed, final_norm
                 + L * d * (hq // 16) + 2 * L * d * (hkv // 16)  # wq wk wv
                 + L * (hq // 16) * d + 2 * L * d      # wo, the two norms
                 + 2 * L * d * (F // 16) + L * (F // 16) * d)  # the FFN
    assert _estimate(cfg, "train_4k", mesh) == _colls(
        all_reduce=2 * (L + L + 1) * per + grads,
        count=2 * (L + L + 1) + 11)


def test_lm_estimate_moe_smoke_by_hand():
    """kimi-k2's smoke config (3 layers: a dense layer 0 and 2 MoE layers
    of 4 experts, top 2, one shared expert, capacity factor 2; d 128)
    on (2, 2), decode_32k: batch 128 over 2 -> 64 rows of one token."""
    cfg = configs.get_smoke("kimi-k2-1t-a32b")
    assert (cfg.n_layers, cfg.n_experts, cfg.top_k, cfg.d_model,
            cfg.capacity_factor) == (3, 4, 2, 128, 2.0)
    per = 64 * 1 * 128 * 2
    # row-split: layer0 wo and w_down, 2 x (wo, sw_down); the embed gather
    reduces = 1 + 1 + 2 + 2 + 1
    # 128 tokens make one routing group of 128 (whole: 1 group does not
    # split over 2); capacity ceil(2 * 128 * 2 / 4) = 128; 2 experts a
    # device; dispatch and combine in each of the 2 MoE layers
    per_way = 2 * 1 * 128 * 128 * 2
    assert _estimate(cfg, "decode_32k", _mesh(2, 2)) == _colls(
        all_reduce=reduces * per, all_to_all=4 * per_way,
        count=reduces + 4)


@pytest.mark.parametrize("sid,lengths,at", [
    ("prefill_32k", (16, 32, 48), 64),
    ("train_4k", (8, 16, 24, 32), 40)])
def test_rwkv6_extension_is_a_direct_count(sid, lengths, at, monkeypatch):
    """The extension equals counting the length itself, flops, bytes, one
    device's bytes and ops (smoke config, batch 2): a prefill's line, a
    train step's parabola, each through lengths shorter than COUNT_AT's
    (for time; the counts are of their degree from the first tokens on)
    and checked at the last of them."""
    cfg = configs.get_smoke("rwkv6-7b")
    kind = shp.SHAPES[sid]["kind"]
    assert len(dryrun.COUNT_AT[kind]) == len(lengths)
    monkeypatch.setitem(shp.SHAPES, sid, {**shp.SHAPES[sid],
                                          "global_batch": 2})
    monkeypatch.setitem(dryrun.COUNT_AT, kind, lengths)
    combo = dataclasses.replace(shp.resolve(cfg, sid), seq_len=at)
    mesh = make_production_mesh()
    got, counted_at = dryrun.count_step(combo, mesh)
    assert counted_at == list(lengths)
    b = dryrun.build(combo, mesh)
    assert got == roofline.count_per_device(b.fn, b.args, mesh.size,
                                            dryrun.held(b.argument_blocks))


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b"])
def test_device_bytes_hold_each_weight_block(arch, monkeypatch):
    """A decode step reads every weight whole (smollm's tied embedding
    makes the logits; kimi's decode reads every expert) but an untied
    embedding, whose rows it gathers, so one device's bytes reach its
    block of those weights at least, and exceed the whole step's
    bytes split over the 256 devices by at least what each weight's one
    read gains from being counted at its block (smoke configs on 16 x
    16, where the weights are replicated over the 16 data replicas; a
    cache of 64 positions)."""
    monkeypatch.setattr(dryrun.configs, "get", configs.get_smoke)
    monkeypatch.setitem(shp.SHAPES, "decode_32k",
                        {**shp.SHAPES["decode_32k"], "seq_len": 64})
    rec = dryrun.run_combo(arch, "decode_32k", False)
    b = dryrun.build(shp.resolve(configs.get_smoke(arch), "decode_32k"),
                     make_production_mesh())
    paths = [p for p, _ in dryrun._leaves(b.params)]
    # an untied embedding is gathered (its rows read), not read whole
    p_blocks = [blk for p, blk in zip(paths, b.argument_blocks)
                if p != "embed" or configs.get_smoke(arch).tie_embeddings]
    p_dev = dryrun.blocks_bytes(p_blocks)
    p_all = sum(t.numel() * t.element_size() for t, _ in p_blocks)
    whole = roofline.count(b.fn, *b.args)["traffic_bytes"]
    dev = rec["roofline"]["bytes_accessed"]
    assert dev >= p_dev
    assert dev - whole / 256 >= p_dev - p_all / 256 > 0


def test_extension_refuses_what_is_not_its_degree():
    """The last point checks the polynomial through the others; one off
    it by a single unit raises, also where every weight is an integer."""
    assert dryrun._extend([(1, 10), (2, 20), (3, 30)], 5) == 50
    assert dryrun._extend([(1, 1), (2, 4), (3, 9), (4, 16)], 7) == 49
    with pytest.raises(ValueError, match="not of degree 1"):
        dryrun._extend([(64, 10), (128, 20), (192, 31)], 32768)
    with pytest.raises(ValueError, match="not of degree 2"):
        dryrun._extend([(64, 1), (128, 4), (192, 9), (256, 17)], 4096)


def _jax_record_keys():
    """The keys JAX's run_combo writes: its ``rec = {...}`` literal and
    every ``rec["..."] = `` after it, in order; the ones written only
    after compiling are those after its ``if not compile_`` return."""
    fn = next(n for n in ast.walk(ast.parse(JAX_DRYRUN.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "run_combo")
    before, after, seen_return = [], [], False
    for node in fn.body:
        if isinstance(node, ast.If) and any(
                isinstance(x, ast.Return) for x in node.body):
            seen_return = True
        for n in ast.walk(node):
            if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id == "rec"):
                before += [k.value for k in n.value.keys]
            elif (isinstance(n, ast.Assign)
                  and isinstance(n.targets[0], ast.Subscript)
                  and n.targets[0].value.id == "rec"):
                (after if seen_return else before).append(
                    n.targets[0].slice.value)
    return before, after


def test_cli_records_have_jaxs_keys(monkeypatch, tmp_path, capsys):
    before, after = _jax_record_keys()
    assert before[-1] == "lower_s" and after[0] == "compile_s"
    monkeypatch.setattr(dryrun.configs, "get", configs.get_smoke)
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "smollm-135m", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(argv + ["--no-count"]) == 0
    assert dryrun.main(argv + ["--mesh", "multipod"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "OK   smollm-135m x decode_32k x 16x16",
        "OK   smollm-135m x decode_32k x 2x16x16"]
    plain, counted = map(json.loads, out.read_text().splitlines())
    # count_s in place of lower_s and compile_s; memory and total_s are
    # JAX's compiled keys, written without the count too
    jax_all = set(before + after)
    assert set(counted) == jax_all - {"lower_s", "compile_s"} | {"count_s"}
    assert set(plain) == set(counted) - {"count_s", "roofline"}
    assert set(j.name for j in dataclasses.fields(
        roofline.RooflineTerms)) | {"split"} == set(
        counted["roofline"])
    assert counted["roofline"]["split"] == "ideal"
    assert plain["memory"]["temp_size_in_bytes"] is None
    assert plain["memory"]["argument_size_in_bytes"] > 0
    assert counted["mesh"] == "2x16x16" and plain["mesh"] == "16x16"


def test_cli_failure_exits_1_with_the_error(monkeypatch, capsys):
    def boom(*a, **k):
        raise ValueError("no fit")
    monkeypatch.setattr(dryrun, "build", boom)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--no-count"]) == 1
    assert capsys.readouterr().out.startswith(
        "FAIL smollm-135m x train_4k x 16x16: ValueError('no fit')")


def test_opt_sets_and_restores_the_levers(monkeypatch):
    """--opt on a MoE decode (smoke widths, production mesh): every hint
    the step hands ``constrain`` resolves against the 16 x 16 mesh, and
    the flags are the defaults again after."""
    from repro_torch.models import moe
    seen = []

    def spy(x, spec):
        if spec is not None:
            assert runtime_flags.FLAGS.mesh.shape == {"data": 16,
                                                      "model": 16}
            seen.append(tuple(spec))
        return runtime_flags.constrain(x, spec)
    monkeypatch.setattr(moe, "constrain", spy)
    monkeypatch.setattr(dryrun.configs, "get", configs.get_smoke)
    before = dataclasses.asdict(runtime_flags.FLAGS)
    rec = dryrun.run_combo("kimi-k2-1t-a32b", "decode_32k", False,
                           count_=True, opt=True)
    assert rec["opt"] is True and rec["roofline"]["flops"] > 0
    # JAX's exp_in_spec and dispatch_spec (a batch of 128 divides 16)
    assert ("model", "data", None, None) in seen
    assert ("data", None, "model", None) in seen
    assert dataclasses.asdict(runtime_flags.FLAGS) == before
    assert runtime_flags.FLAGS.mesh is None
