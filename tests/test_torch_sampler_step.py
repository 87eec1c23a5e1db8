"""The port's sampler-step kernels (plain versions, the CPU path of the
wrappers) and layout helpers against the JAX package's Pallas kernels,
which run in interpret mode as the JAX tests run them.

Tolerances:
  * PRNG uint32 bits, layouts, derived seeds: bitwise.
  * Deterministic steps in float32 (no clip, clip, want_x0): bitwise — the
    plain version emulates the FMAs XLA:CPU contracts the kernel body into.
  * Stochastic steps: 4 float32 ulps of max|out| — Box–Muller's log/cos
    are correctly rounded float64 libm values on the CPU, not XLA's float32
    ones (measured: at most 1 ulp of max|z| apart).
  * bfloat16 or float16 state: 1 ulp of that type of max|out| (a float32
    difference of an ulp can flip one rounding to the 16-bit type).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.kernels.sampler_step import kernel as jk
from repro.kernels.sampler_step import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels.sampler_step import kernel as tk
from repro_torch.kernels.sampler_step import ops as tops
from repro_torch.kernels.sampler_step import ref

F32_ULP = float(np.finfo(np.float32).eps)
BF16_ULP = 2.0 ** -7
F16_ULP = 2.0 ** -10
SEEDS = [0, 1, 123456789, -1, -2 ** 31, 2 ** 31 - 1, -987654321]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------------------ PRNG
def test_fmix32_bitwise():
    rs = np.random.RandomState(0)
    u = np.concatenate([rs.randint(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    got = ref.fmix32(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  _u32(jk._fmix32(jnp.asarray(u))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rows", [8, 256])
def test_sw_random_bits_bitwise(seed, rows):
    """JAX's per-tile stream is the port's whole-array stream, sliced at
    that tile: 8 tiles of ``rows`` rows, so the granule is ``rows``."""
    tids = (0, 1, 7)
    for salt in (1, 2):
        whole = ref.tile_bits(seed, rows * (max(tids) + 1), salt)
        for tid in tids:
            want = _u32(jk.sw_random_bits(np.int32(seed), tid, salt,
                                          (rows, 256)))
            got = whole[tid * rows:(tid + 1) * rows]
            np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                          want)


@pytest.mark.parametrize("R", [16, 24, 512])
def test_tile_bits_match_per_tile_stream(R):
    """The whole-array stream is the JAX per-tile stream, tile by tile."""
    tr = jk.tile_rows(R)
    for seed in (5, -77):
        for salt in (1, 2):
            want = np.concatenate([
                _u32(jk.sw_random_bits(np.int32(seed), i, salt, (tr, 256)))
                for i in range(R // tr)])
            got = ref.tile_bits(seed, R, salt)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                          want)


@pytest.mark.parametrize("R", [8, 16, 256, 512])
def test_sw_random_bits_rows_bitwise(R):
    rs = np.random.RandomState(R)
    seeds = np.concatenate([rs.randint(-2 ** 31, 2 ** 31, R - 2),
                            [-1, 2 ** 31 - 1]]).astype(np.int32)
    for salt in (1, 2):
        want = _u32(jk.sw_random_bits_rows(jnp.asarray(seeds), 0, salt,
                                           (R, 256)))
        got = ref.sw_random_bits_rows(torch.from_numpy(seeds), 0, salt,
                                      (R, 256))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_bits_to_normal_within_two_ulps():
    """The CPU plain version's normals (float64 log / cos rounded to
    float32, independent of PyTorch's CPU code paths) stay within 2 float32
    ulps of max|z| of XLA's float32 Box–Muller, on every run."""
    b1 = jk.sw_random_bits(np.int32(-12345), 3, 1, (256, 256))
    b2 = jk.sw_random_bits(np.int32(-12345), 3, 2, (256, 256))
    want = np.asarray(jk.bits_to_normal(b1, b2))
    got = ref.bits_to_normal(torch.from_numpy(_u32(b1).astype(np.int64)),
                             torch.from_numpy(_u32(b2).astype(np.int64)))
    tol = 2 * F32_ULP * float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= tol


def test_bits_to_normal_cpu_is_correctly_rounded_numpy():
    """On the CPU the plain Box–Muller is numpy end to end: float64 log /
    cos rounded to float32, float32 sqrt and product, bitwise.  PyTorch's
    float32 CPU sqrt is not correctly rounded, and on some runs one
    intra-op thread's chunk came out ~2**-12 off, which made the two-ulp
    test above fail now and then."""
    rs = np.random.RandomState(11)
    b1 = rs.randint(0, 2 ** 32, (256, 256), dtype=np.uint64)
    b2 = rs.randint(0, 2 ** 32, (256, 256), dtype=np.uint64)
    u1 = ((b1 >> 8).astype(np.float32) + np.float32(0.5)) * np.float32(
        2.0 ** -24)
    arg = np.float32(2.0 * np.pi) * ((b2 >> 8).astype(np.float32)
                                     * np.float32(2.0 ** -24))
    want = (np.sqrt(np.float32(-2.0) * np.log(u1.astype(np.float64)).astype(
        np.float32)) * np.cos(arg.astype(np.float64)).astype(np.float32))
    got = ref.bits_to_normal(torch.from_numpy(b1.astype(np.int64)),
                             torch.from_numpy(b2.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- layouts
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (3, 5, 7), (4, 32, 32, 3),
                                   (1, 256, 256), (2, 300, 256)])
def test_tile_layout_bitwise(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    j2, jn = jops.to_tile_layout(jnp.asarray(x))
    t2, tn = tops.to_tile_layout(torch.from_numpy(x))
    assert tn == jn
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    back = tops.from_tile_layout(t2, tn, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.from_tile_layout(j2, jn, shape)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (3, 16, 16), (2, 32, 32, 3)])
def test_slot_tile_layout_bitwise(shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    assert tops.slot_rows(shape[1:]) == jops.slot_rows(shape[1:])
    j2, jn = jops.to_slot_tile_layout(jnp.asarray(x))
    t2, tn = tops.to_slot_tile_layout(torch.from_numpy(x))
    assert tn == jn
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    back = tops.from_slot_tile_layout(t2, tn, shape)
    np.testing.assert_array_equal(back.numpy(), x)


def test_expand_slot_coefs_and_derive_row_seeds_bitwise():
    rs = np.random.RandomState(3)
    coefs = rs.rand(3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tops.expand_slot_coefs(torch.from_numpy(coefs), 16).numpy(),
        np.asarray(jops.expand_slot_coefs(jnp.asarray(coefs), 16)))
    seeds = np.array(SEEDS, np.int32)
    for rps in (1, 8, 16):
        got = tops.derive_row_seeds(torch.from_numpy(seeds), rps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.derive_row_seeds(jnp.asarray(seeds),
                                                          rps)))


# ----------------------------------------------------------------- steps
def _inputs(R, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(R, 256) * 2).astype(np.float32)
    eps = rs.randn(R, 256).astype(np.float32)
    return x, eps


def _assert_step_close(got, want, dtype_key, exact):
    got, want = _np(got), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if dtype_key in ("bf16", "f16"):
        tol = (BF16_ULP if dtype_key == "bf16" else F16_ULP) * scale
    else:
        tol = 0.0 if exact else 4 * F32_ULP * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("R", [16, 512])
@pytest.mark.parametrize("dtype_key", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("stochastic", [False, True])
def test_scalar_step_vs_pallas(R, dtype_key, clip, stochastic):
    jd, td = DTYPES[dtype_key]
    x, eps = _inputs(R)
    coefs = np.array([0.9, 0.3, 1.0, 0.6, 0.8], np.float32)
    seed = -424242 if stochastic else None
    want = jk.sampler_step_2d(jnp.asarray(x, jd), jnp.asarray(eps, jd),
                              jnp.asarray(coefs), seed, clip=clip,
                              stochastic=stochastic)
    got = tk.sampler_step_2d(torch.from_numpy(x).to(td),
                             torch.from_numpy(eps).to(td), coefs, seed,
                             clip=clip, stochastic=stochastic)
    assert got.dtype == td and got.shape == (R, 256)
    _assert_step_close(got, want, dtype_key, exact=not stochastic)


def test_scalar_step_mixed_dtypes_vs_pallas():
    """bfloat16 state with a float32 eps, as a float32 model gives it."""
    x, eps = _inputs(16, seed=4)
    coefs = np.array([0.7, 0.5, 0.0, 0.4, 0.9], np.float32)
    want = jk.sampler_step_2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(eps),
                              jnp.asarray(coefs))
    got = tk.sampler_step_2d(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(eps), coefs)
    _assert_step_close(got, want, "bf16", exact=True)


def test_scalar_step_float16_state_float32_eps_vs_pallas():
    """A float16 state with a float32 eps (a float32 model's output under
    JAX's promotion), each loaded with its own type."""
    x, eps = _inputs(16, seed=5)
    coefs = np.array([0.7, 0.5, 0.0, 0.4, 0.9], np.float32)
    want = jk.sampler_step_2d(jnp.asarray(x, jnp.float16), jnp.asarray(eps),
                              jnp.asarray(coefs))
    got = tk.sampler_step_2d(torch.from_numpy(x).half(),
                             torch.from_numpy(eps), coefs)
    assert got.dtype == torch.float16
    _assert_step_close(got, want, "f16", exact=True)


@pytest.mark.parametrize("R", [16, 512])
@pytest.mark.parametrize("dtype_key", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("want_x0", [False, True])
def test_rows_step_vs_pallas(R, dtype_key, clip, stochastic, want_x0):
    jd, td = DTYPES[dtype_key]
    x, eps = _inputs(R, seed=1)
    rs = np.random.RandomState(R)
    row_coefs = np.zeros((R, 8), np.float32)
    row_coefs[:, :5] = rs.uniform(0.05, 1.0, (R, 5))
    row_coefs[:, 2] = 1.0
    seeds = rs.randint(-2 ** 31, 2 ** 31, R).astype(np.int32)
    kw = dict(clip=clip, stochastic=stochastic, want_x0=want_x0)
    want = jk.sampler_step_rows_2d(
        jnp.asarray(x, jd), jnp.asarray(eps, jd), jnp.asarray(row_coefs),
        jnp.asarray(seeds) if stochastic else None, **kw)
    got = tk.sampler_step_rows_2d(
        torch.from_numpy(x).to(td), torch.from_numpy(eps).to(td),
        torch.from_numpy(row_coefs),
        torch.from_numpy(seeds) if stochastic else None, **kw)
    if want_x0:
        (got, got_x0), (want, want_x0_) = got, want
        _assert_step_close(got_x0, want_x0_, dtype_key, exact=True)
    _assert_step_close(got, want, dtype_key, exact=not stochastic)


def test_step_checks_inputs():
    x = torch.zeros(12, 256)
    with pytest.raises(ValueError, match="multiple"):
        tk.sampler_step_2d(x, x, np.ones(5, np.float32))
    with pytest.raises(ValueError, match="seed"):
        tk.sampler_step_2d(torch.zeros(8, 256), torch.zeros(8, 256),
                           np.ones(5, np.float32), stochastic=True)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tk.sampler_step_2d(torch.zeros(8, 256, dtype=torch.float64),
                           torch.zeros(8, 256), np.ones(5, np.float32))
    with pytest.raises(ValueError, match="row_coefs"):
        tk.sampler_step_rows_2d(torch.zeros(8, 256), torch.zeros(8, 256),
                                torch.zeros(8, 5))


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """A tensor off the CPU launches the kernel or raises; here (no card,
    no nvcc) it must raise and count no launch."""
    before = (tk.sampler_step_2d.launches, tk.sampler_step_rows_2d.launches)
    calls = []
    monkeypatch.setattr(ref, "sampler_step_2d",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(ref, "sampler_step_rows_2d",
                        lambda *a, **k: calls.append(a))
    x = torch.empty(8, 256, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.sampler_step_2d(x, x, np.ones(5, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        tk.sampler_step_rows_2d(x, x, torch.empty(8, 8, device="meta"))
    assert calls == []
    assert (tk.sampler_step_2d.launches,
            tk.sampler_step_rows_2d.launches) == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    assert "sampler_step" in build.sources()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("sampler_step")


@pytest.mark.parametrize("name", ["sampler_step_2d", "sampler_step_rows_2d"])
def test_launch_shape_of_the_card_kernels(name):
    """Blocks of 256 threads, 4 elements (one vector) per thread for
    deterministic steps and 1 for stochastic ones: the grid covers the
    (R, 256) state, and the wrapper has no other launch setting."""
    wrapper = getattr(tk, name)
    assert tk.grid(96, False) == 24 and tk.grid(96, True) == 96
    assert tk.grid(128, False) == 32 and tk.grid(128, True) == 128
    assert tk.grid(8, False) == 2 and tk.grid(768, True) == 768
    assert [k for k in vars(wrapper) if not k.startswith("_")] == [
        "launches"]
