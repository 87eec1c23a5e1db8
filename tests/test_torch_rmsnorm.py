"""B6 RMSNorm: the port's ``rms_norm`` (plain version on the CPU) against
the JAX package's Pallas kernel (interpret mode) and its model RMSNorm,
on the same numpy inputs.

Tolerances: float32 2e-6 absolute and relative, as ``test_kernels.py``
holds the JAX kernel to the model norm (sums in another order); bfloat16
and float16 one ulp of the type of max|out| (the products are rounded to
the type in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.kernels import rms_norm_kernel
from repro.models import common as jcommon
from repro_torch.kernels.rmsnorm import kernel as tk
from repro_torch.kernels.rmsnorm import ops as tops
from repro_torch.kernels.rmsnorm import ref as tref
from repro_torch.models import common as tcommon

ULP = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "f16": (np.float32, jnp.float16, torch.float16)}
# then: the ops path's rows at smollm width, a d that takes the CUDA
# kernel's scalar row path (d % 4 != 0), and a row past what the one-pass
# path holds (the long-row kernel on the card)
SHAPES = [(4, 128), (3, 17, 96), (2, 5, 7, 64), (1000, 256), (1, 64),
          (2048, 576), (256, 190), (2, 20000)]


def _inputs(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    s = rs.randn(shape[-1]).astype(np.float32)
    _, jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(x, jdt), jnp.asarray(s, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(tdt)))


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    else:
        tol = ULP[dtype] * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rms_norm_matches_jax_kernel(shape, dtype):
    (jx, js), (tx, ts) = _inputs(shape, dtype)
    _assert_close(tops.rms_norm(tx, ts), rms_norm_kernel(jx, js), dtype)


@pytest.mark.parametrize("scale_t", ["bf16", "f16"])
def test_float32_x_over_a_16bit_scale(scale_t):
    """JAX's kernel promotes (x * inv) * scale to float32 over a 16-bit
    scale; the port matches within the float32 tolerance."""
    (jx, _), (tx, _) = _inputs((64, 576), "f32", seed=3)
    (_, js), (_, ts) = _inputs((64, 576), scale_t, seed=4)
    want = rms_norm_kernel(jx, js)
    assert want.dtype == jnp.float32
    got = tops.rms_norm(tx, ts)
    assert got.dtype == torch.float32
    _assert_close(got, want, "f32")


def test_rms_norm_2d_refuses_a_16bit_x_over_another_scale():
    """JAX raises on a 16-bit x over a scale of another type; off the
    CPU (a meta tensor stands for the card) the wrapper refuses it."""
    x = torch.empty(256, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32 over"):
        tk.rms_norm_2d(x, torch.empty(64, device="meta"))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_matches_jax_model_norm(dtype):
    (jx, js), (tx, ts) = _inputs((4, 33, 192), dtype, seed=1)
    want = jcommon.rms_norm(jx, js)
    _assert_close(tops.rms_norm(tx, ts), want, dtype)
    _assert_close(tcommon.rms_norm(tx, ts), want, dtype)


@pytest.mark.parametrize("R", [1, 300, 1000])
def test_padding_rows_change_nothing(R):
    """ops pads R to the kernel's row granule; the live rows are bitwise
    the plain body of the unpadded rows (each row is normalised alone)."""
    _, (tx, ts) = _inputs((R, 96), "f32", seed=R)
    torch.testing.assert_close(tops.rms_norm(tx, ts),
                               tref.rms_norm_body(tx, ts, 1e-5),
                               rtol=0, atol=0)
    torch.testing.assert_close(tcommon.rms_norm(tx, ts),
                               tref.rms_norm_body(tx, ts, 1e-5),
                               rtol=0, atol=0)


def test_rms_norm_2d_checks_its_rows():
    x = torch.zeros(300, 64)
    with pytest.raises(ValueError, match="multiple"):
        tk.rms_norm_2d(x, torch.ones(64))
    with pytest.raises(ValueError, match=r"\(R, d\)"):
        tk.rms_norm_2d(x, torch.ones(32))
    n0 = tk.rms_norm_2d.launches
    tk.rms_norm_2d(torch.zeros(256, 64), torch.ones(64))
    assert tk.rms_norm_2d.launches == n0      # the CPU path counts nothing
