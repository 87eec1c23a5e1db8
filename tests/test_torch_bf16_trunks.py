"""Trunks whose state and weights are of two types, against the JAX
package: ``eps_forward`` promotes a product of a bfloat16 and a float32
operand to float32, as ``jnp.matmul`` does.

The dense trunk at the three mixed combinations (state / weights bf16 /
f32, f32 / bf16, bf16 / bf16) against JAX's.  Tolerances, of max|eps|:
1e-4 where the trunk is float32 (products summed in another order), 2e-2
for the bfloat16 trunk (the repo's bfloat16 tolerance,
``tests/test_kernels.py``).  The moe, ssm and hybrid trunks where both
packages run the pair, at the smoke widths of their tests; what the port
does not run yet is in ``ROADMAP.md`` queue 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
import _torch_mega as mega_trunks
from repro.diffusion_lm import model as jdlm
from repro_torch.diffusion_lm import model as tdlm

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


FAMILY_CASES = [("kimi-k2-1t-a32b", "bf16", "f32"),
                ("rwkv6-7b", "bf16", "f32"), ("rwkv6-7b", "bf16", "bf16"),
                ("zamba2-2.7b", "bf16", "f32"),
                ("zamba2-2.7b", "bf16", "bf16")]


@pytest.mark.parametrize("arch,state,weights", FAMILY_CASES,
                         ids=[f"{a.split('-')[0]}-{s}-{w}"
                              for a, s, w in FAMILY_CASES])
def test_other_family_trunks_mixed_types_match_jax(arch, state, weights):
    """The moe (GQA), ssm and hybrid trunks at the smoke widths of their
    tests, where both packages run the pair."""
    jcfg, tcfg, jp, tp = lm.dlm_pair(arch)
    got, want = _eps_pair(jcfg, tcfg, jp, tp, state, weights)
    both16 = state == weights == "bf16"
    assert got.dtype == (torch.bfloat16 if both16 else torch.float32)
    assert _rel(got, want) <= (BF16_TOL if both16 else F32_TRUNK_TOL)
