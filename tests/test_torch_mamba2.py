"""Mamba2 blocks of the port (``models/mamba2.py``) against the JAX
package's on the CPU: the chunked SSD (S a multiple of the chunk and not,
a nonzero state0, decays large enough that exp overflows above the
diagonal) and its gradients (finite where JAX's dt gradient is NaN, and
held there against jax.grad of the SSD's step-by-step recurrence), the
causal conv, the block forward, and the single-token
recurrence against the chunked forward.

Tolerances: ``ssd_chunked`` and ``mamba_forward`` 1e-5 of max|.| of
JAX's (the three-operand contractions and the cumsum sum in another
order than XLA's); the causal conv 1e-6 of max|.| (the same four
products and sums, SiLU by another library); the recurrence against the
chunked forward 1e-5 of max|y| (two summation orders of one recurrence).

In bfloat16, as JAX's dry run runs every combo: the smoke zamba2
``forward``, ``prefill``, ``decode_step`` and every cache leaf within
``BF16_TOL`` = 4e-2 of max|.| of JAX's (jitted) on the same bfloat16
weights and tokens.  JAX's own bfloat16 forward lies 2.3e-2 of
max|logits| from its float32 forward on those weights (XLA keeps excess
precision between fused bfloat16 ops, eager PyTorch rounds after each
op), so the two bfloat16 results differ by about that much (1.7e-2 to
3.0e-2 here); the port's bfloat16 forward
also stays within 1.25x JAX's distance from that float32 forward.  The
mean train loss of one ``make_lm_train_step`` within 1e-3 relative of
the loss JAX's step reports (its ``lm_loss_fn`` on the same weights).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import mamba2 as jm
from repro_torch import configs, prng
from repro_torch.models import common as tcommon
from repro_torch.models import mamba2 as tm

from _torch_lm import close, np_tree

SSD_TOL = 1e-5
CONV_TOL = 1e-6
BF16_TOL = 4e-2
BF16_VS_F32 = 1.25
BF16_LOSS_RTOL = 1e-3


def _ssd_inputs(seed, Bt, S, H, P, N, dt_scale):
    rs = np.random.RandomState(seed)
    x = rs.randn(Bt, S, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(rs.randn(Bt, S, H))) * dt_scale).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    B = rs.randn(Bt, S, N).astype(np.float32)
    C = rs.randn(Bt, S, N).astype(np.float32)
    D = rs.randn(H).astype(np.float32)
    state0 = rs.randn(Bt, H, P, N).astype(np.float32)
    return x, dt, A, B, C, D, state0


@pytest.mark.parametrize("S,dt_scale", [(256, 0.1), (200, 0.1), (40, 0.1),
                                        (128, 1.0)],
                         ids=["two-chunks", "padded", "one-short-chunk",
                              "overflowing-decay"])
def test_ssd_chunked_matches_jax(S, dt_scale):
    args = _ssd_inputs(S, 2, S, 4, 8, 16, dt_scale)
    wy, ws = jm.ssd_chunked(*map(jnp.asarray, args))
    gy, gs = tm.ssd_chunked(*map(torch.from_numpy, args))
    assert gy.shape == (2, S, 4, 8) and gs.dtype == torch.float32
    if dt_scale == 1.0:
        # above the diagonal exp(cum_i - cum_j) is inf: masked, not NaN
        cum = np.cumsum(args[1] * args[2], axis=1)
        assert (cum[:, :, None] - cum[:, None, :]).max() > 88.0
        assert bool(torch.isfinite(gy).all())
    close(gy, wy, SSD_TOL)
    close(gs, ws, SSD_TOL)


def _jax_recurrence(x, dt, A, B, C, D, state0):
    """The SSD as its recurrence (``repro/models/mamba2.py``'s docstring),
    one step at a time: every decay exp(dt_t A) is at most 1, so its
    gradient is finite wherever the chunked form's exp overflows."""
    def step(state, inp):
        xt, dtt, Bt, Ct = inp
        a = jnp.exp(dtt * A)                                   # (Bt,H)
        state = (a[..., None, None] * state
                 + (dtt[..., None] * xt)[..., None] * Bt[:, None, None, :])
        return state, (jnp.einsum("bhpn,bn->bhp", state, Ct)
                       + D[None, :, None] * xt)
    _, y = jax.lax.scan(step, state0, tuple(
        jnp.moveaxis(a, 1, 0) for a in (x, dt, B, C)))
    return jnp.moveaxis(y, 0, 1)


@pytest.mark.parametrize("S,dt_scale", [(40, 0.01), (128, 1.0)],
                         ids=["finite-decay", "overflowing-decay"])
def test_ssd_chunked_gradients(S, dt_scale):
    """d sum(y * w) by x, dt, B and C against jax.grad of JAX's
    ``ssd_chunked`` and of the SSD's step-by-step recurrence.  Where the
    decay above the diagonal overflows, JAX's chunked dt gradient is NaN
    (its where's backward multiplies 0 by inf) and the port's, which
    takes exp below the diagonal only, is held against the recurrence's;
    every other gradient agrees with both (SSD_TOL)."""
    x, dt, A, B, C, D, s0 = _ssd_inputs(7, 2, S, 4, 8, 16, dt_scale)
    cum = np.cumsum(dt * A, axis=1)
    assert ((cum[:, :, None] - cum[:, None, :]).max() > 88.0) == (
        dt_scale == 1.0)
    w = np.random.RandomState(8).randn(2, S, 4, 8).astype(np.float32)

    def jloss(ssd):
        def loss(x, dt, B, C):
            y = ssd(x, dt, jnp.asarray(A), B, C, jnp.asarray(D),
                    jnp.asarray(s0))
            return jnp.sum(y * w)
        return loss

    jargs = tuple(map(jnp.asarray, (x, dt, B, C)))
    want = jax.grad(jloss(lambda *a: jm.ssd_chunked(*a)[0]),
                    argnums=(0, 1, 2, 3))(*jargs)
    recur = jax.grad(jloss(_jax_recurrence), argnums=(0, 1, 2, 3))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, B, C)]
    y, _ = tm.ssd_chunked(leaves[0], leaves[1], torch.from_numpy(A),
                          leaves[2], leaves[3], torch.from_numpy(D),
                          torch.from_numpy(s0))
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    for name, g, wg, rg in zip(("x", "dt", "B", "C"), got, want, recur):
        assert bool(torch.isfinite(g).all()), name
        close(g, rg, SSD_TOL)
        if name == "dt" and dt_scale == 1.0:
            assert not np.isfinite(np.asarray(wg)).all()
            continue
        close(g, wg, SSD_TOL)


def test_causal_conv_matches_jax():
    rs = np.random.RandomState(3)
    seq = rs.randn(2, 9, 24).astype(np.float32)
    w = rs.randn(4, 24).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    prev = rs.randn(2, 3, 24).astype(np.float32)
    wo, wp = jm._causal_conv(*map(jnp.asarray, (seq, w, b, prev)))
    go, gp = tm._causal_conv(*map(torch.from_numpy, (seq, w, b, prev)))
    close(go, wo, CONV_TOL)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gp.numpy(), seq[:, -3:])


def _block(seed=0):
    jcfg = jconfigs.get_smoke("zamba2-2.7b")
    tcfg = configs.get_smoke("zamba2-2.7b")
    jp = jm.init_mamba_params(jcommon.KeyGen(jax.random.PRNGKey(seed)),
                              jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in np_tree(jp).items()}
    return jcfg, tcfg, jp, tp


def test_split_and_sizes_are_jax():
    jcfg, tcfg, _, tp = _block()
    assert (tm.d_inner(tcfg), tm.n_ssm_heads(tcfg)) == (
        jm.d_inner(jcfg), jm.n_ssm_heads(jcfg)) == (256, 8)
    assert tm.mamba_shapes(tcfg) == {k: tuple(v.shape)
                                     for k, v in tp.items()}
    proj = torch.arange(2 * 3 * tp["w_in"].shape[1]).reshape(2, 3, -1)
    want = jm._split_in(jnp.asarray(proj.numpy()), jcfg)
    for g, w in zip(tm._split_in(proj, tcfg), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [7, 130])
def test_mamba_forward_matches_jax(S):
    jcfg, tcfg, jp, tp = _block()
    x = np.random.RandomState(S).randn(2, S, tcfg.d_model).astype(
        np.float32)
    conv, ssm = (a + 0.1 for a in jm.init_mamba_state(jcfg, 2, jnp.float32))
    want = jm.mamba_forward(jp, jcfg, jnp.asarray(x), conv, ssm)
    got = tm.mamba_forward(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(np.array(conv)),
                           torch.from_numpy(np.array(ssm)))
    for g, w in zip(got, want):
        close(g, w, SSD_TOL)


def test_decode_recurrence_matches_chunked_forward():
    """Token by token, mamba_decode_step gives the chunked forward's
    outputs and states (JAX's decode step agrees with them too)."""
    jcfg, tcfg, jp, tp = _block(1)
    S = 6
    x = np.random.RandomState(2).randn(2, S, tcfg.d_model).astype(np.float32)
    conv, ssm = tm.init_mamba_state(tcfg, 2, device="cpu")
    y_full, conv_f, ssm_f = tm.mamba_forward(tp, tcfg, torch.from_numpy(x),
                                             conv, ssm)
    jconv, jssm = jm.init_mamba_state(jcfg, 2, jnp.float32)
    for s in range(S):
        y, conv, ssm = tm.mamba_decode_step(
            tp, tcfg, torch.from_numpy(x[:, s:s + 1]), conv, ssm)
        jy, jconv, jssm = jm.mamba_decode_step(
            jp, jcfg, jnp.asarray(x[:, s:s + 1]), jconv, jssm)
        close(y, y_full[:, s:s + 1].numpy(), SSD_TOL)
        close(y, jy, SSD_TOL)
    close(ssm, ssm_f.numpy(), SSD_TOL)
    close(conv, conv_f.numpy(), SSD_TOL)


def test_init_draws_are_jax_and_a_log_dt_bias_within_two_ulps():
    from _torch_lm import INIT_ULPS, ulp_gap
    jcfg, tcfg, jp, _ = _block(4)
    got = tm.init_mamba_params(tcommon.KeyGen(prng.PRNGKey(4, "cpu")), tcfg)
    for k, w in np_tree(jp).items():
        if k in ("A_log", "dt_bias"):
            assert ulp_gap(got[k].numpy(), w) <= INIT_ULPS, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # zamba2's 80 heads (at a narrow width): A from -1 down to -16, dt in
    # [1e-3, 0.1]
    full = dataclasses.replace(tcfg, d_model=320, ssm_head_dim=8)
    H = tm.n_ssm_heads(full)
    a = tm.init_mamba_params(tcommon.KeyGen(prng.PRNGKey(0, "cpu")), full)
    assert H == 80 and a["A_log"].shape == (80,)
    np.testing.assert_allclose(np.exp(a["A_log"].numpy())[[0, -1]],
                               [1.0, 16.0], rtol=1e-6)
    dt = torch.nn.functional.softplus(a["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


# --------------------------------------------------------------- bfloat16
@pytest.fixture(scope="module")
def bf16_pair():
    """zamba2's smoke config, JAX's init drawn in bfloat16 and the same
    bfloat16 weights in the port."""
    from repro.models import registry as jregistry
    from repro_torch import interop
    from repro_torch.models import registry as tregistry
    arch = "zamba2-2.7b"
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    japi, tapi = jregistry.get_api(jcfg), tregistry.get_api(tcfg)
    jp = jax.jit(lambda k: japi.init_params(k, jcfg, dtype=jnp.bfloat16))(
        jax.random.PRNGKey(0))
    f32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tp = jax.tree.map(lambda t: t.to(torch.bfloat16),
                      interop.lm_params_from_jax(f32, tcfg))
    return jcfg, tcfg, japi, tapi, jp, tp, f32


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _close_bf16(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(_f32(got), _f32(want), BF16_TOL)


def test_bf16_forward_matches_jax(bf16_pair):
    jcfg, tcfg, japi, tapi, jp, tp, f32 = bf16_pair
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    fwd = jax.jit(lambda p, x: japi.forward(p, jcfg, x)[0])
    want = fwd(jp, jnp.asarray(toks))
    got, _ = tapi.forward(tp, tcfg, torch.from_numpy(toks))
    _close_bf16(got, want)
    ref = np.asarray(fwd(jax.tree.map(jnp.asarray, f32), jnp.asarray(toks)))
    jax_gap = np.abs(_f32(want) - ref).max()
    assert np.abs(_f32(got) - ref).max() <= BF16_VS_F32 * jax_gap


def test_bf16_prefill_and_decode_match_jax(bf16_pair):
    jcfg, tcfg, japi, tapi, jp, tp, _ = bf16_pair
    P, N = 6, 3
    toks = np.random.RandomState(2).randint(0, tcfg.vocab,
                                            (2, P + N)).astype(np.int32)
    jc = japi.init_cache(jcfg, 2, P + N, jnp.bfloat16)
    tc = tapi.init_cache(tcfg, 2, P + N, dtype=torch.bfloat16, device="cpu")
    jl, jc = jax.jit(lambda p, x, c: japi.prefill(p, jcfg, x, c))(
        jp, jnp.asarray(toks[:, :P]), jc)
    tl, tc = tapi.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]), tc)
    _close_bf16(tl, jl)
    decode = jax.jit(lambda p, x, c: japi.decode_step(p, jcfg, x, c))
    for s in range(P, P + N):
        jl, jc = decode(jp, jnp.asarray(toks[:, s:s + 1]), jc)
        tl, tc = tapi.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, s:s + 1]), tc)
        _close_bf16(tl, jl)
    for k in jc:
        if k != "idx":
            _close_bf16(tc[k], jc[k])


def test_bf16_train_loss_matches_jax(bf16_pair):
    from repro.models import registry as jregistry
    from repro.training import steps as jsteps
    from repro_torch.training import optim as topt
    from repro_torch.training import steps as tsteps
    jcfg, tcfg, _, _, jp, tp, _ = bf16_pair
    toks = np.random.RandomState(3).randint(0, tcfg.vocab, (4, 24)).astype(
        np.int32)
    opt = topt.AdamWConfig(lr=1e-3)
    _, m = tsteps.make_lm_train_step(tcfg, opt)(
        tsteps.init_train_state(tp, prng.PRNGKey(1, "cpu"), opt),
        {"tokens": torch.from_numpy(toks)})
    # the loss JAX's train step reports is its lm_loss_fn's on the
    # params before the update (jitted alone: a quarter of the compile)
    japi = jregistry.get_api(jcfg)
    _, jm = jax.jit(lambda p, x: jsteps.lm_loss_fn(japi, jcfg, p, x, None))(
        jp, jnp.asarray(toks))
    want = float(jm["loss"])
    assert np.isfinite(float(m["loss"]))
    assert abs(float(m["loss"]) - want) <= BF16_LOSS_RTOL * abs(want)
