"""The 3xTF32 product of the megakernels B3/B4, held on the CPU through its
plain version ``megastep.ref.tf32x3_matmul``.

The card's kernel splits each float32 operand of the trunk's products into
a TF32 "big" part (``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, low 13 bits cleared) and the TF32 rounding of the remainder, and sums
small.big + big.small + big.big on the tensor cores.  These tests show that
this keeps float32-level products, so the card tolerance of B3/B4 against
their float32 plain versions (1e-4 of max|state|) keeps its room:

  * ``tf32_round`` gives the bits of round-to-nearest-ties-away at 10
    mantissa bits (hand-made ties and a float64 reference);
  * at the trunk's depths (K 576 and 1536) the 3xTF32 product is within
    2**-20 of max(|A| @ |B|) of the float64 product, as plain float32 is
    (measured 1.3e-7 and 7.5e-8), while one TF32 product is not (~5e-5);
  * an 8-step ``megastep_ref`` whose token products (the ones the kernel
    puts on the tensor cores: x @ w with a 2-D weight) run as
    ``tf32x3_matmul`` stays within 1e-5 of max|state| of the float32 run
    (measured 4.0e-7 'exact', 4.8e-7 'flash').
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch import prng
from repro_torch.core import make_schedule
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.kernels.megastep import ref
from repro_torch.models.common import ArchConfig
from repro_torch.sampling import SamplerPlan

PRODUCT_TOL = 2.0 ** -20       # of max(|A| @ |B|): a few float32 ulps
STATE_TOL = 1e-5               # of max|state|, 10x inside the card's 1e-4


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, nearest, ties away from zero,
    in float64 arithmetic (normal numbers)."""
    x64 = x.astype(np.float64)
    e = np.floor(np.log2(np.abs(x64)))
    ulp = 2.0 ** (e - 10)
    q = np.abs(x64) / ulp
    r = np.floor(q + 0.5)            # ties (q = n + 0.5) go up: away from 0
    return (np.sign(x64) * r * ulp).astype(np.float32)


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),                # tie: away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),             # tie, odd: up
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),                # below half: down
    (2.0 - 2.0 ** -23, 2.0),                             # carry into exp
    (0.0, 0.0),
], ids=["one", "tie", "neg-tie", "odd-tie", "below-half", "carry", "zero"])
def test_tf32_round_ties_away_from_zero(value, want):
    got = ref.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == want
    assert int(got.view(torch.int32)[0]) & 0x1FFF == 0


def test_tf32_round_matches_float64_reference():
    rs = np.random.RandomState(3)
    x = (rs.randn(20000) * np.exp(rs.uniform(-20, 20, 20000))
         ).astype(np.float32)
    # and exact ties: a 10-bit mantissa plus half of its last bit
    bits = (rs.randint(0x00800000, 0x7F000000, 2000).astype(np.uint32)
            & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    x = np.concatenate([x, bits.view(np.float32), -bits.view(np.float32)])
    got = ref.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _rna_reference(x).view(np.uint32))


@pytest.mark.parametrize("K", [576, 1536])
def test_tf32x3_matmul_is_float32_accurate(K):
    rs = np.random.RandomState(K)
    a = torch.from_numpy(rs.randn(256, K).astype(np.float32))
    b = torch.from_numpy((rs.randn(K, 192) / np.sqrt(K)).astype(np.float32))
    want = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())

    def err(c):
        return float((c.double() - want).abs().max()) / scale
    assert err(ref.tf32x3_matmul(a, b)) <= PRODUCT_TOL
    assert err(a @ b) <= PRODUCT_TOL                 # float32, the yardstick
    one_pass = err(ref.tf32_round(a) @ ref.tf32_round(b))
    assert one_pass > 30 * PRODUCT_TOL               # why three passes


class _Tf32x3Products(TorchFunctionMode):
    """Runs ``x @ w`` with a 2-D weight and a (batch, tokens, .) input as
    ``tf32x3_matmul``: the trunk's token products (w_in, q/k/v, wo, gate,
    up, down, w_out), which the kernel puts on the tensor cores.  The time
    MLP's products (2-D input) and attention stay float32, as on the
    card."""

    MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
    calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in self.MATMULS and len(args) == 2 and not kwargs
                and args[0].dim() >= 3 and args[1].dim() == 2):
            lhs, w = args
            self.calls += 1
            out = ref.tf32x3_matmul(lhs.reshape(-1, lhs.shape[-1]), w)
            return out.reshape(*lhs.shape[:-1], w.shape[1])
        return func(*args, **kwargs)


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_megastep_ref_with_tf32x3_products_within_1e5(attn_impl):
    arch = ArchConfig(name="t", family="dense", n_layers=2, d_model=192,
                      n_heads=3, n_kv_heads=1, d_ff=512, vocab=50)
    cfg = tdlm.DiffusionLMConfig(arch=arch, time_dim=64)
    params = tdlm.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    eps_params = {k: params[k] for k in tdlm.EPS_PATH}
    batch, seq, K = 2, 64, 8
    x2 = torch.from_numpy(np.random.RandomState(1).randn(
        batch * seq * cfg.latent_dim // 256, 256).astype(np.float32))
    tab = SamplerPlan.build(make_schedule("linear", 1000), K).steps()
    coefs = torch.from_numpy(np.stack(
        [tab[c] for c in ("c_x0", "c_dir", "c_noise", "sqrt_a_t",
                          "sqrt_1m_a_t")], 1).astype(np.float32))
    ts = torch.from_numpy(np.array(tab["t"], np.int32))
    args = (x2, eps_params, cfg, batch, seq, coefs, ts)
    want = ref.megastep_ref(*args, attn_impl=attn_impl)
    mode = _Tf32x3Products()
    with mode:
        got = ref.megastep_ref(*args, attn_impl=attn_impl)
    # every step: w_in, w_out and per layer q, k, v, wo, gate, up, down
    assert mode.calls == K * (2 + 7 * arch.n_layers)
    diff = float((got - want).abs().max())
    assert 0.0 < diff <= STATE_TOL * float(want.abs().max())
