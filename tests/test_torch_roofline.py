"""The port's roofline terms (``repro_torch.launch.roofline``) against the
JAX package's (``repro/launch/roofline.py``) and against analytic counts.

Exact: ``lm_model_flops``; ``analyze``'s arithmetic (JAX's ``analyze``
run on the same counts, its hardware constants set to the H100's, to
float64 rounding); ``count``'s flops of a smoke dense forward against the
analytic matmul count; counting on meta tensors against counting on real
CPU tensors (flops, bytes and ops); the bytes of a gather, an in-place
scatter, an overwrite and an in-place update, op by op.
``test_count_vs_hlo_aggregate`` prints the ratio of ``count``'s flops to
``hlo_analysis.aggregate``'s on the same forward (run with ``-s`` to read
it); it is reported, not gated.

Exact, the collective term: ``analyze`` with ``n_chips`` 1, 4 and 256,
``links_per_chip`` 1 and 2 and a collective dict, against JAX's
``analyze`` on the same numbers (its ``aggregate`` patched to return
them, its rates set to the H100's, ``ICI_BW`` to ``NVLINK_BW``);
``pool_collective_bytes`` of the fleet bench's demo trunk (state_dim 512,
hidden 1024, 4 slots) on (1, 1), (1, 2) and (2, 2) CPU meshes and of a
CIFAR10-shaped pool on (2, 1), of the same pool's engine on (1, 1) with
the eps on (2, 1) (the eps cuts the batch), and of a plain eps on (2, 1)
(the engine gathers its state), against bytes worked out by hand, with
the engine's own eps plan.  ``count_per_device`` of a product whose
weight one device holds half of, by hand.

Bounded: a smoke dense decode step's bytes against the analytic traffic
(every weight read once, the cache read once, one slot a layer written),
which they exceed by the step's activations alone, under 10% of it (at
batch 2 also by the copies eager ``einsum`` makes of the permuted K and V
caches before its batched products, read and written: twice the cache);
its flops equal ``aggregate``'s on JAX's decode step and its bytes stay
under ``aggregate``'s, which writes the whole new cache.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
import repro.launch.hlo_analysis as j_hlo
import repro.launch.roofline as j_roofline
from repro import configs as jconfigs
from repro.models import dense as j_dense
from repro_torch import configs, prng
from repro_torch.launch import roofline
from repro_torch.models import dense, unet

B, S = 2, 16


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


def _smoke_dense():
    cfg = configs.get_smoke("smollm-135m")
    params = dense.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (B, S)).astype(np.int32))
    return cfg, params, tokens


def _analytic_forward_flops(cfg, b, s):
    """2 per multiply-add of every product of a dense forward."""
    d, D, F, V = cfg.d_model, cfg.hd(), cfg.d_ff, cfg.vocab
    hq, hkv = cfg.n_heads * D, cfg.n_kv_heads * D
    per_layer = (2 * b * s * d * (hq + 2 * hkv)       # q, k, v
                 + 2 * b * s * hq * d                 # wo
                 + 2 * 2 * b * cfg.n_heads * s * s * D  # q k^T, p v
                 + 3 * 2 * b * s * d * F)             # gate, up, down
    return cfg.n_layers * per_layer + 2 * b * s * d * V


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,d", [(135_000_000, 4096), (7, 3)])
def test_lm_model_flops_is_jaxs(kind, n, d):
    assert roofline.lm_model_flops(n, d, kind) == \
        j_roofline.lm_model_flops(n, d, kind)


@pytest.mark.parametrize("counts", [
    {"flops": 3.2e12, "traffic_bytes": 1.1e9},      # compute-bound
    {"flops": 4.0e9, "traffic_bytes": 7.5e10},      # memory-bound
    {"flops": 0.0, "traffic_bytes": 0.0}])
@pytest.mark.parametrize("model_flops", [None, 2.5e12])
def test_analyze_is_jaxs_arithmetic(counts, model_flops, monkeypatch):
    agg = {"flops": counts["flops"], "traffic_bytes": counts["traffic_bytes"],
           "coll_bytes_total": 0.0, "coll_count": 0,
           "coll_bytes": {k: 0 for k in j_hlo._COLLECTIVES}}
    monkeypatch.setattr(j_hlo, "aggregate", lambda text: agg)
    monkeypatch.setattr(j_roofline, "PEAK_FLOPS_BF16",
                        roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(j_roofline, "HBM_BW", roofline.HBM_BW)
    want = j_roofline.analyze(None, "", n_chips=1, model_flops=model_flops)
    got = roofline.analyze(counts, model_flops=model_flops,
                           dtype=torch.bfloat16)
    for f in ("flops", "bytes_accessed", "coll_bytes", "compute_s",
              "memory_s", "collective_s", "bottleneck", "model_flops",
              "useful_ratio"):
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.as_dict()) == set(want.as_dict())


def test_analyze_float32_runs_without_tensor_cores():
    t = roofline.analyze({"flops": 6.7e12, "traffic_bytes": 0.0})
    assert t.compute_s == 6.7e12 / 67e12 and t.bottleneck == "compute"
    assert roofline.peak_flops(torch.bfloat16) == 989e12
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS_TF32) == (3.35e12, 495e12)
    with pytest.raises(ValueError):
        roofline.peak_flops(torch.int8)


def test_count_dense_forward_is_the_analytic_matmul_flops():
    cfg, params, tokens = _smoke_dense()
    c = roofline.count(dense.forward, params, cfg, tokens)
    assert c["flops"] == _analytic_forward_flops(cfg, B, S)
    assert c["traffic_bytes"] > sum(v.numel() * 4 for _, v in
                                    _flat(params)) and c["ops"] > 0


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("op", ["index", "embedding", "index_select"])
def test_count_gather_reads_its_rows_not_its_table(op):
    table = torch.zeros(512, 64)
    idx = torch.tensor([[3, 7, 7, 1]])
    fn = {"index": lambda: table[idx],
          "embedding": lambda: torch.nn.functional.embedding(idx, table),
          "index_select": lambda: table.index_select(0, idx[0])}[op]
    rows = fn()
    assert roofline.count(fn)["traffic_bytes"] == \
        2 * _nbytes(rows) + _nbytes(idx)


def test_count_inplace_updates():
    """index_copy_ and index_put_ write their update (read and written)
    plus their index; copy_ into a slice writes the slice and reads the
    source; add_ reads both operands and writes its own; an out= argument
    is written, not read."""
    cache = torch.zeros(2, 64, 3, 16)
    slot = torch.tensor([5])
    row = torch.ones(2, 1, 3, 16)
    c = roofline.count(lambda: cache.index_copy_(1, slot, row))
    assert c["traffic_bytes"] == 2 * _nbytes(row) + _nbytes(slot)

    def put():
        cache[:, slot] = row
    c = roofline.count(put)
    assert c["traffic_bytes"] == 2 * _nbytes(row) + _nbytes(slot)
    c = roofline.count(lambda: cache[:, 5:6].copy_(row))
    assert c["traffic_bytes"] == 2 * _nbytes(row)
    c = roofline.count(lambda: cache.add_(1.0))
    assert c["traffic_bytes"] == 2 * _nbytes(cache)
    c = roofline.count(lambda: torch.add(row, row, out=torch.empty_like(row)))
    assert c["traffic_bytes"] == 2 * _nbytes(row)


def _decode_counts(B, M=64):
    cfg, params, _ = _smoke_dense()
    cache = dense.init_cache(cfg, B, M, device="cpu")
    tok = torch.zeros(B, 1, dtype=torch.int64)
    c = roofline.count(dense.decode_step, params, cfg, tok, cache)
    weights = _nbytes(*(v for _, v in _flat(params)))
    kv = _nbytes(cache["k"], cache["v"])
    slots = cfg.n_layers * 2 * B * cfg.n_kv_heads * cfg.hd() * 4
    return cfg, params, c, weights, kv, slots


@pytest.mark.parametrize("B", [1, 2])
def test_count_decode_step_bytes_are_the_analytic_traffic(B):
    _, _, c, weights, kv, slots = _decode_counts(B)
    analytic = weights + kv + slots
    copies = 0 if B == 1 else 2 * kv
    extra = c["traffic_bytes"] - analytic - copies
    assert 0 < extra < 0.1 * analytic, (c, analytic, copies)


@pytest.mark.parametrize("B", [1, 2])
def test_count_decode_step_vs_hlo_aggregate(B):
    cfg, _, c, _, _, _ = _decode_counts(B)
    jcfg = jconfigs.get_smoke("smollm-135m")
    jparams = j_dense.init_params(jax.random.PRNGKey(0), jcfg)
    compiled = jax.jit(functools.partial(j_dense.decode_step, cfg=jcfg)
                       ).lower(jparams, tokens=jnp.zeros((B, 1), jnp.int32),
                               cache=j_dense.init_cache(jcfg, B, 64)
                               ).compile()
    agg = j_hlo.aggregate(compiled.as_text())
    print(f"\ncount / aggregate, smollm-135m smoke decode step (batch {B}, "
          f"cache 64): flops {c['flops']} / {agg['flops']:.0f}, bytes "
          f"{c['traffic_bytes']} / {agg['traffic_bytes']:.0f} = "
          f"{c['traffic_bytes'] / agg['traffic_bytes']:.4f}")
    assert c["flops"] == agg["flops"]
    assert c["traffic_bytes"] < agg["traffic_bytes"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("step", ["forward", "decode_step"])
def test_count_on_meta_equals_count_on_cpu(step):
    cfg, params, tokens = _smoke_dense()
    if step == "forward":
        real = roofline.count(dense.forward, params, cfg, tokens)
        meta = roofline.count(dense.forward, _to_meta(params), cfg,
                              _to_meta(tokens))
    else:
        cache = dense.init_cache(cfg, B, 2 * S, device="cpu")
        _, cache = dense.prefill(params, cfg, tokens, cache)
        meta_cache = _to_meta(cache)
        real = roofline.count(dense.decode_step, params, cfg, tokens[:, :1],
                              cache)
        meta = roofline.count(dense.decode_step, _to_meta(params), cfg,
                              _to_meta(tokens[:, :1]), meta_cache)
    assert meta == real


def test_count_convolutions_of_the_unet():
    """The U-Net's flops are its convolutions' and products' (the
    flop_counter formulas see aten.convolution), the same on meta.  Its
    ops and bytes are not: group norm runs as one CPU kernel but
    decomposes into several ops on meta tensors."""
    cfg = configs.TOY_UNET
    model = unet.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    x = torch.zeros(2, 16, 16, 3)
    t = torch.ones(2, dtype=torch.int32)
    real = roofline.count(model, x, t)
    assert real["flops"] > 0
    meta_model = unet.UNet(cfg, device="meta")
    meta = roofline.count(meta_model, _to_meta(x), _to_meta(t))
    assert meta["flops"] == real["flops"]


def test_memory_report_off_cuda_is_empty():
    assert roofline.memory_report("cpu") == {}


def test_count_vs_hlo_aggregate():
    """count's flops over hlo_analysis.aggregate's on the same smoke dense
    forward (JAX lowered and compiled on the CPU); reported, not gated."""
    cfg, params, tokens = _smoke_dense()
    jcfg = jconfigs.get_smoke("smollm-135m")
    jparams = j_dense.init_params(jax.random.PRNGKey(0), jcfg)
    compiled = jax.jit(functools.partial(j_dense.forward, cfg=jcfg)).lower(
        jparams, tokens=jnp.asarray(tokens.numpy())).compile()
    agg = j_hlo.aggregate(compiled.as_text())
    c = roofline.count(dense.forward, params, cfg, tokens)
    ratio = c["flops"] / agg["flops"]
    print(f"\ncount / aggregate flops, smollm-135m smoke forward "
          f"({B} x {S}): {c['flops']} / {agg['flops']:.0f} = {ratio:.4f}; "
          f"bytes {c['traffic_bytes']} / {agg['traffic_bytes']:.0f} = "
          f"{c['traffic_bytes'] / agg['traffic_bytes']:.4f}")
    assert np.isfinite(ratio) and ratio > 0


# ---------------------------------------------------- the collective term
@pytest.mark.parametrize("n_chips", [1, 4, 256])
@pytest.mark.parametrize("links", [1, 2])
def test_analyze_with_collectives_is_jaxs(n_chips, links, monkeypatch):
    kinds = dict(zip(j_hlo._COLLECTIVES,
                     (301_989_888, 1_207_959_552, 0, 536_870_912, 8_208)))
    agg = {"flops": 4.4e12, "traffic_bytes": 2.2e10, "coll_bytes": kinds,
           "coll_bytes_total": sum(kinds.values()), "coll_count": 61}
    monkeypatch.setattr(j_hlo, "aggregate", lambda text: agg)
    monkeypatch.setattr(j_roofline, "PEAK_FLOPS_BF16",
                        roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(j_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(j_roofline, "ICI_BW", roofline.NVLINK_BW)
    want = j_roofline.analyze(None, "", n_chips, model_flops=9.9e14,
                              links_per_chip=links)
    got = roofline.analyze(agg, n_chips, model_flops=9.9e14,
                           links_per_chip=links, dtype=torch.bfloat16,
                           coll={**kinds, "count": 61})
    assert got.as_dict() == want.as_dict()
    assert got.collective_s == sum(kinds.values()) / (450e9 * links)
    assert roofline.COLLECTIVES == j_hlo._COLLECTIVES


def test_analyze_defaults_are_one_card_without_collectives():
    t = roofline.analyze({"flops": 1.0, "traffic_bytes": 2.0},
                         model_flops=3.0)
    assert (t.coll_bytes, t.collective_s, t.useful_ratio) == (0.0, 0.0, 3.0)
    assert t.coll_breakdown == {**{k: 0 for k in j_hlo._COLLECTIVES},
                                "count": 0}


DIM, HIDDEN, SLOTS = 512, 1024, 4          # the fleet bench's demo trunk
UNET_ELEMS = 32 * 32 * 3                  # a CIFAR10 sample


def _pool_engine(mesh, apply_style, eps_mesh=None):
    """The engine phase 15 builds on ``mesh`` (on the CPU): the demo trunk
    through make_sharded_eps, a CIFAR10-shaped apply through
    sharded_eps_from_apply (on ``eps_mesh``, ``mesh`` by default), or that
    apply as a plain function."""
    from repro_torch.core.schedules import make_schedule
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.fleet import (make_sharded_eps,
                                           make_trunk_params,
                                           sharded_eps_from_apply)
    sch = make_schedule("linear", 1000)
    if apply_style == "trunk":
        params = make_trunk_params(sch, DIM, HIDDEN, seed=0, device="cpu")
        return ContinuousBatchingEngine(
            sch, make_sharded_eps(mesh, params), (DIM,), SLOTS, mesh=mesh,
            device="cpu")
    eps = (sharded_eps_from_apply(eps_mesh or mesh, {"w": torch.ones(1)},
                                  lambda p, x, t: x * p["w"])
           if apply_style == "unet" else (lambda x, t: x * 1.0))
    return ContinuousBatchingEngine(sch, eps, (32, 32, 3), SLOTS,
                                    mesh=mesh, device="cpu")


# x_i (k rows of 512 float32), t_i (k int32), per the hand counts below
_X1, _T1 = 4 * DIM * 4, 4 * 4             # one data block of 4 rows
_X2, _T2 = 2 * DIM * 4, 2 * 4             # two data blocks of 2 rows
_U2, _UT2 = 2 * UNET_ELEMS * 4, 2 * 4
# a CIFAR10 sample is 12 slot-tile rows of 256 float32, padded to the
# step kernel's 8-row granule: 16; 2 slots a block
_S2 = 2 * 16 * 256 * 4
POOL_CASES = {
    # engine (data, model), eps, eps (data, model), per-block plan:
    # {kind: bytes}, count
    "trunk (1, 1)": ((1, 1), "trunk", None, True, {}, 0),
    # x and t to (0, 1); its partial back to (0, 0)
    "trunk (1, 2)": ((1, 2), "trunk", None, True,
                     {"collective-permute": _X1 + _T1, "all-reduce": _X1},
                     3),
    # per block i: x_i and t_i to (i, 1), its partial back to (i, 0)
    "trunk (2, 2)": ((2, 2), "trunk", None, True,
                     {"collective-permute": 2 * (_X2 + _T2),
                      "all-reduce": 2 * _X2}, 6),
    # blocks already on (i, 0), weights copied there at build: nothing
    "unet (2, 1)": ((2, 1), "unet", None, True, {}, 0),
    # an eps for another mesh: MeshEps(x, t) on the whole batch, x_1 and
    # t_1 cut to (1, 0), eps_1 back
    "unet (2, 1) whole call": ((1, 1), "unet", (2, 1), False,
                               {"collective-permute": _U2 + _UT2,
                                "all-gather": _U2}, 3),
    # a plain eps: state block 1 gathered onto (0, 0), its eps cut back
    "plain eps (2, 1)": ((2, 1), "plain", None, False,
                         {"all-gather": _S2, "collective-permute": _S2}, 2),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_collective_bytes_by_hand(case):
    from repro_torch.launch.mesh import make_host_mesh

    def mesh_of(data, model):
        return make_host_mesh(model, devices=[torch.device("cpu")]
                              * (data * model))
    (data, model), style, eps_dm, per_block, kinds, n = POOL_CASES[case]
    eng = _pool_engine(mesh_of(data, model), style,
                       eps_dm and mesh_of(*eps_dm))
    assert eng.eps_plan()["per_block"] is per_block
    want = {**{k: 0 for k in roofline.COLLECTIVES}, **kinds, "count": n}
    assert roofline.pool_collective_bytes(eng) == want


def test_count_per_device_by_hand():
    """x (8, 16) @ w (16, 32) over 4 devices, w's block a half of it (split
    over a model axis of 2): w's bytes at 1/2, x's and the product's at
    1/4; a view of w (its transpose) counts as w; a tensor the step makes
    is split."""
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")
    wb, xb, yb = 16 * 32 * 4, 8 * 16 * 4, 8 * 32 * 4
    got = roofline.count_per_device(lambda x, w: x @ w, (x, w), 4,
                                    [(w, wb // 2), (x, xb // 4)])
    assert got["device_bytes"] == wb / 2 + xb / 4 + yb / 4
    assert got["traffic_bytes"] == wb + xb + yb
    got = roofline.count_per_device(lambda w: (w.t() * 2.0).sum(), (w,),
                                    4, [(w, wb // 2)])
    # mul reads w (a half) and writes a new (32, 16); sum reads it (split)
    assert got["device_bytes"] == wb / 2 + wb / 4 + wb / 4 + 4 / 4
    assert got["traffic_bytes"] == roofline.count(
        lambda w: (w.t() * 2.0).sum(), w)["traffic_bytes"]
    with pytest.raises(ValueError, match="share one storage"):
        roofline.count_per_device(lambda w: w, (w,), 4,
                                  [(w, wb), (w[1:], wb)])
