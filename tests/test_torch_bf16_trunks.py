"""Trunks whose state and weights are of two types, against the JAX
package: ``eps_forward`` promotes a product of a bfloat16 and a float32
operand to float32, as ``jnp.matmul`` does.

The dense trunk at the three mixed combinations (state / weights bf16 /
f32, f32 / bf16, bf16 / bf16) against JAX's.  Tolerances, of max|eps|:
1e-4 where the trunk is float32 (products summed in another order), 2e-2
for the bfloat16 trunk (the repo's bfloat16 tolerance,
``tests/test_kernels.py``).  The moe (MLA and GQA), ssm and hybrid trunks
at the smoke widths of their tests, float32 state over bfloat16 weights
and the reverse: their products go through ``models.common.matmul`` /
``einsum``, which promote as ``jnp.matmul`` / ``jnp.einsum`` do.  The AR
path of every family with a float32 embedding table over bfloat16
weights (``forward``, ``prefill``, ``decode_step``), and the promoting
helpers themselves, which leave products of one type untouched.  (A moe
trunk with state and weights both bfloat16 is not held to JAX's eps:
``ROADMAP.md``, known gaps.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
import _torch_mega as mega_trunks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.diffusion_lm import model as jdlm
from repro.models import registry as jregistry
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry

JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}
F32_TRUNK_TOL = 1e-4
BF16_TOL = 2e-2


def _jcast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, tree)


def _eps_pair(jcfg, tcfg, jp, tp, state, weights, seed=1):
    """(port eps, JAX eps) for a state / weights type pair."""
    x = np.random.RandomState(seed).randn(2, 64, 32).astype(np.float32)
    t = np.array([999, 17], np.int32)
    want = jdlm.eps_forward(_jcast(jp, JDT[weights]), jcfg,
                            jnp.asarray(x).astype(JDT[state]),
                            jnp.asarray(t), remat=False)
    got = tdlm.eps_forward(mega_trunks.cast(tp, TDT[weights]), tcfg,
                           torch.from_numpy(x).to(TDT[state]),
                           torch.from_numpy(t))
    return got, want


def _rel(got, want) -> float:
    w = np.asarray(want.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - w).max() / np.abs(w).max())


COMBOS = [("bf16", "f32"), ("f32", "bf16"), ("bf16", "bf16")]


@pytest.mark.parametrize("state,weights", COMBOS,
                         ids=[f"{s}-{w}" for s, w in COMBOS])
@pytest.mark.parametrize("hd", [16, 64], ids=["hd16-gqa", "hd64"])
def test_dense_eps_forward_mixed_types_match_jax(hd, state, weights):
    jcfg, tcfg, jp, tp = mega_trunks.trunk(hd)
    got, want = _eps_pair(jcfg, tcfg, jp, tp, state, weights)
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    both16 = state == weights == "bf16"
    assert got.dtype == (torch.bfloat16 if both16 else torch.float32)
    assert _rel(got, want) <= (BF16_TOL if both16 else F32_TRUNK_TOL)


# one init per arch for the module's cases (eps_forward reads the trees)
_dlm_pair = functools.cache(lm.dlm_pair)

FAMILY_CASES = [("kimi-k2-1t-a32b", "bf16", "f32"),
                ("rwkv6-7b", "bf16", "f32"), ("rwkv6-7b", "bf16", "bf16"),
                ("zamba2-2.7b", "bf16", "f32"),
                ("zamba2-2.7b", "bf16", "bf16"),
                ("deepseek-v2-236b", "f32", "bf16"),
                ("deepseek-v2-236b", "bf16", "f32"),
                ("kimi-k2-1t-a32b", "f32", "bf16"),
                ("rwkv6-7b", "f32", "bf16"), ("zamba2-2.7b", "f32", "bf16")]


@pytest.mark.parametrize("arch,state,weights", FAMILY_CASES,
                         ids=[f"{a.split('-')[0]}-{s}-{w}"
                              for a, s, w in FAMILY_CASES])
def test_other_family_trunks_mixed_types_match_jax(arch, state, weights):
    """The moe (MLA and GQA), ssm and hybrid trunks at the smoke widths
    of their tests."""
    jcfg, tcfg, jp, tp = _dlm_pair(arch)
    got, want = _eps_pair(jcfg, tcfg, jp, tp, state, weights)
    both16 = state == weights == "bf16"
    assert got.dtype == (torch.bfloat16 if both16 else torch.float32)
    assert _rel(got, want) <= (BF16_TOL if both16 else F32_TRUNK_TOL)


# one arch a family that raised in ``forward``: moe (kimi-k2; deepseek-v2's
# MLA is held through its trunk above), vlm over the dense trunk, ssm,
# hybrid, audio; the dense family raised in its cache path (below)
AR_ARCHS = ["kimi-k2-1t-a32b", "llava-next-mistral-7b", "rwkv6-7b",
            "zamba2-2.7b", "seamless-m4t-large-v2"]


def _ar_pair(arch):
    """JAX's and the port's weights of ``arch`` in bfloat16 but the
    embedding table, and the two registry APIs."""
    jcfg, tcfg, jp, tp = lm.pair(arch)
    jp = dict(_jcast(jp, jnp.bfloat16), embed=jp["embed"])
    tp = dict(mega_trunks.cast(tp, torch.bfloat16), embed=tp["embed"])
    return (jcfg, tcfg, jp, tp, jregistry.get_api(jcfg),
            tregistry.get_api(tcfg))


@pytest.mark.parametrize("arch", AR_ARCHS)
def test_ar_forward_float32_embeddings_over_bf16_weights_match_jax(arch):
    """Every family's ``forward`` with a float32 embedding table over
    bfloat16 weights (and float32 stub frames where the family takes
    them), against JAX's: float32 logits within 1e-4 of max|logits| (JAX
    promotes each product)."""
    jcfg, tcfg, jp, tp, japi, tapi = _ar_pair(arch)
    toks = lm.tokens(1, 2, 7, tcfg.vocab)
    emb = lm.frames(tcfg, 2)
    jkw = {} if emb is None else {"embeds": jnp.asarray(emb)}
    tkw = {} if emb is None else {"embeds": torch.from_numpy(emb)}
    want, _ = japi.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    got, _ = tapi.forward(tp, tcfg, torch.from_numpy(toks), **tkw)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= F32_TRUNK_TOL


def test_ar_cache_path_float32_embeddings_over_bf16_weights_match_jax():
    """The dense family's ``prefill`` and ``decode_step`` on the same
    types (the attention cache path every family's decode shares), which
    raised where ``forward`` ran."""
    jcfg, tcfg, jp, tp, japi, tapi = _ar_pair("smollm-135m")
    toks = lm.tokens(1, 2, 7, tcfg.vocab)
    jc = japi.init_cache(jcfg, 2, 7)
    tc = tapi.init_cache(tcfg, 2, 7, device="cpu")
    jl, jc = japi.prefill(jp, jcfg, jnp.asarray(toks[:, :6]), jc)
    tl, tc = tapi.prefill(tp, tcfg, torch.from_numpy(toks[:, :6]), tc)
    assert tl.dtype == torch.float32 and _rel(tl, jl) <= F32_TRUNK_TOL
    jl, _ = japi.decode_step(jp, jcfg, jnp.asarray(toks[:, 6:]), jc)
    tl, _ = tapi.decode_step(tp, tcfg, torch.from_numpy(toks[:, 6:]), tc)
    assert _rel(tl, jl) <= F32_TRUNK_TOL


def test_promoting_helpers_leave_one_type_untouched():
    """``matmul`` / ``einsum`` on operands of one type are plain ``@`` /
    ``torch.einsum`` bit for bit (so same-type trunks are unchanged);
    on two types they multiply in the promoted type."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 5, 7, generator=g), torch.randn(7, 4, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        x, w = a.to(dt), b.to(dt)
        assert torch.equal(tcommon.matmul(x, w), x @ w)
        assert torch.equal(tcommon.einsum("bsd,de->bse", x, w),
                           torch.einsum("bsd,de->bse", x, w))
    wb = b.to(torch.bfloat16)
    got = tcommon.matmul(a, wb)
    assert got.dtype == torch.float32 and torch.equal(got, a @ wb.float())
    got = tcommon.einsum("bsd,de->bse", a, wb)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum("bsd,de->bse", a, wb.float()))
    want = jnp.einsum("bsd,de->bse", jnp.asarray(a.numpy()),
                      jnp.asarray(b.numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
