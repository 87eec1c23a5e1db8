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
