"""B7, the legacy fused DDIM update: the port's plain version (the CPU path
of ``ddim_step_2d``) against the JAX package's Pallas kernel in interpret
mode and its Eq. 12 oracle, on the same numpy inputs.

Tolerances:
  * float32 against the Pallas kernel: bitwise.  The plain version
    computes the FMAs XLA:CPU contracts the kernel body into (probed).
  * bfloat16 against the Pallas kernel: 1 bfloat16 ulp of max|out| (both
    round every op to bfloat16; a float32 sum of two bfloat16 values may
    round twice in another place).
  * against the oracle ``ddim_step_ref``, which rounds x0 on its own:
    8 float32 ulps of max|out| (the kernel's a / b form divides before it
    multiplies); in bfloat16 4 bfloat16 ulps of max|out|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.kernels.ddim_step.kernel import ddim_step_2d as j_ddim_step_2d
from repro.kernels.ddim_step.ref import ddim_step_ref as j_ddim_step_ref
from repro_torch.kernels.ddim_step import kernel as tk
from repro_torch.kernels.ddim_step import ref as tref

F32_ULP = float(np.finfo(np.float32).eps)
BF16_ULP = 2.0 ** -7
F16_ULP = 2.0 ** -10
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
COEFS = [np.array([0.93, 0.31, 0.27, 0.61, 0.79], np.float32),
         np.array([1.0, 0.0, 0.0, 1.0, 0.0], np.float32),
         np.array([0.999, 0.044, 0.0, 0.0316, 0.9995], np.float32)]


def _inputs(R, C, dtype, seed):
    rs = np.random.RandomState(seed)
    x, e, z = (rs.randn(R, C).astype(np.float32) * s for s in (3.0, 1.0, 1.0))
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(v, jdt) for v in (x, e, z)],
            [torch.from_numpy(v).to(tdt) for v in (x, e, z)])


@pytest.mark.parametrize("R", [256, 1024])
@pytest.mark.parametrize("C", [256, 512])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("ci", range(len(COEFS)))
def test_plain_version_vs_pallas(R, C, dtype, ci):
    (jx, je, jz), (tx, te, tz) = _inputs(R, C, dtype, seed=R + C + ci)
    coefs = COEFS[ci]
    want = np.asarray(j_ddim_step_2d(jx, je, jz, jnp.asarray(coefs)),
                      np.float32)
    got = tk.ddim_step_2d(tx, te, tz, torch.from_numpy(coefs))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (R, C)
    got = got.float().numpy()
    if dtype in ("f32", "f16"):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


# a float32 x over each non-uniform (eps, noise) type pair JAX admits
MIXES = [(e, z) for e in DTYPES for z in DTYPES if (e, z) != ("f32", "f32")]


@pytest.mark.parametrize("eps_t,noise_t", MIXES)
def test_plain_version_vs_pallas_mixed(eps_t, noise_t):
    """A float32 x over 16-bit eps and / or noise: JAX promotes them to
    float32, and the plain version widens them first; bitwise."""
    rs = np.random.RandomState(len(eps_t) * 3 + len(noise_t))
    x, e, z = (rs.randn(256, 512).astype(np.float32) * s
               for s in (3.0, 1.0, 1.0))
    coefs = COEFS[0]
    jx = jnp.asarray(x)
    je, jz = (jnp.asarray(v, DTYPES[t][0]) for v, t in ((e, eps_t),
                                                         (z, noise_t)))
    tx = torch.from_numpy(x)
    te, tz = (torch.from_numpy(v).to(DTYPES[t][1]) for v, t in
              ((e, eps_t), (z, noise_t)))
    want = np.asarray(j_ddim_step_2d(jx, je, jz, jnp.asarray(coefs)))
    assert want.dtype == np.float32
    got = tk.ddim_step_2d(tx, te, tz, torch.from_numpy(coefs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_a_16bit_x_over_other_types():
    """JAX raises on a 16-bit x over operands of another type; off the
    CPU (a meta tensor stands for the card) the wrapper refuses them."""
    x = torch.empty(256, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32 over"):
        tk.ddim_step_2d(x, x.float(), x, torch.ones(5))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_plain_version_vs_oracle(dtype):
    (jx, je, jz), (tx, te, tz) = _inputs(256, 256, dtype, seed=7)
    coefs = COEFS[0]
    want = np.asarray(j_ddim_step_ref(jx, je, jz, *[jnp.asarray(c, jx.dtype)
                                                    for c in coefs]),
                      np.float32)
    tref_out = tref.ddim_step_ref(tx, te, tz,
                                  *torch.from_numpy(coefs).to(tx.dtype))
    got = tk.ddim_step_2d(tx, te, tz, torch.from_numpy(coefs))
    ulp = {"f32": F32_ULP, "bf16": BF16_ULP, "f16": F16_ULP}[dtype]
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 8 * ulp * scale
    # the port's oracle is the JAX oracle's op order
    assert (np.abs(tref_out.float().numpy() - want).max()
            <= (0 if dtype == "f32" else 1) * ulp * scale)


@pytest.mark.parametrize("shape", [(255, 256), (256, 300), (512, 128),
                                   (0, 256)])
def test_wrapper_refuses_ragged_shapes(shape):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="multiples"):
        tk.ddim_step_2d(x, x, x, torch.ones(5))


def test_wrapper_checks_inputs():
    x = torch.zeros(256, 256)
    with pytest.raises(ValueError, match="one \\(R, C\\) shape"):
        tk.ddim_step_2d(x, torch.zeros(256, 512), x, torch.ones(5))
    with pytest.raises(ValueError, match="coefs"):
        tk.ddim_step_2d(x, x, x, torch.ones(4))


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """A tensor off the CPU launches the kernel or raises; here (no card)
    it must raise and count no launch."""
    before = tk.ddim_step_2d.launches
    calls = []
    monkeypatch.setattr(tref, "ddim_step_body",
                        lambda *a, **k: calls.append(a))
    x = torch.empty(256, 256, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.ddim_step_2d(x, x, x, torch.ones(5))
    assert calls == [] and tk.ddim_step_2d.launches == before
