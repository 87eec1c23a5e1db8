"""Shared checks of an LM family of the port against the JAX package on
the CPU at its smoke config (``tests/test_torch_{mamba2,hybrid,rwkv6,
encdec}.py``).  Weights are JAX's init carried across by
``interop.lm_params_from_jax``; tokens and frame embeddings come from
numpy seeds.

Tolerances:
  * ``forward``, ``prefill`` and decode logits, and the caches: 1e-5 of
    max|.| of JAX's (float32 products and reductions sum in another
    order);
  * the cache path against the port's own cache-free forward of the same
    tokens: ``FWD_TOL`` of max|logits| for each family (the hybrid's
    cached decode runs the single-token recurrence where forward runs the
    chunked SSD, which sums in another order, and holds it too);
  * drawn init leaves bitwise; ``APPROX_LEAVES`` (Mamba2's ``A_log`` and
    ``dt_bias``, functions of a linspace or a uniform through torch's
    float32 log / exp / expm1) within ``INIT_ULPS`` float32 ulps of the
    value.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs, interop, prng
from repro_torch.models import registry as tregistry

TOL_OF_SCALE = 1e-5
FWD_TOL = 1e-5
APPROX_LEAVES = ("A_log", "dt_bias")
INIT_ULPS = 2


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def pair(arch, seed=0):
    """(jcfg, tcfg, JAX params, the port's params carried across)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jregistry.get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, interop.lm_params_from_jax(np_tree(jp), tcfg)


def close(got, want, tol=TOL_OF_SCALE):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def frames(cfg, B, seed=7):
    """Stub frame / patch embeddings for a family that needs them."""
    if not tregistry.get_api(cfg).needs_embeds:
        return None
    return (np.random.RandomState(seed).randn(B, cfg.n_ctx_embeds,
                                              cfg.d_model) * 0.02).astype(
        np.float32)


def _kw(emb, to):
    return {} if emb is None else {"embeds": to(emb)}


def check_forward(arch):
    jcfg, tcfg, jp, tp = pair(arch)
    toks = tokens(1, 2, 11, tcfg.vocab)
    emb = frames(tcfg, 2)
    want, jaux = jregistry.get_api(jcfg).forward(
        jp, jcfg, jnp.asarray(toks), **_kw(emb, jnp.asarray))
    got, aux = tregistry.get_api(tcfg).forward(
        tp, tcfg, torch.from_numpy(toks), **_kw(emb, torch.from_numpy))
    close(got, want)
    assert aux.shape == () and float(aux) == float(jaux) == 0.0


def check_prefill_decode(arch, P=6, N=3):
    """prefill + N decode steps against JAX's (logits and every cache
    leaf), and against the port's cache-free forward."""
    jcfg, tcfg, jp, tp = pair(arch)
    japi, tapi = jregistry.get_api(jcfg), tregistry.get_api(tcfg)
    toks = tokens(2, 2, P + N, tcfg.vocab)
    emb = frames(tcfg, 2)
    M = P + N
    jc = japi.init_cache(jcfg, 2, M)
    tc = tapi.init_cache(tcfg, 2, M, device="cpu")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
    jl, jc = japi.prefill(jp, jcfg, jnp.asarray(toks[:, :P]), jc,
                          **_kw(emb, jnp.asarray))
    tl, same = tapi.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]), tc,
                            **_kw(emb, torch.from_numpy))
    assert same is tc                     # written in place
    close(tl, jl)
    assert int(tc["idx"]) == int(jc["idx"]) == P
    full, _ = tapi.forward(tp, tcfg, torch.from_numpy(toks),
                           **_kw(emb, torch.from_numpy))
    close(tl, full[:, P - 1].numpy(), FWD_TOL)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    for s in range(P, P + N):
        jl, jc = japi.decode_step(jp, jcfg, jnp.asarray(toks[:, s:s + 1]), jc)
        tl, tc = tapi.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, s:s + 1]), tc)
        close(tl, jl)
        close(tl, full[:, s].numpy(), FWD_TOL)
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
    assert int(tc["idx"]) == int(jc["idx"]) == P + N
    for k in jc:
        if k != "idx":
            close(tc[k], jc[k])


def ulp_gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| in float32 ulps of want."""
    spacing = np.spacing(np.abs(want).astype(np.float32))
    return float((np.abs(got.astype(np.float64) - want) / spacing).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def check_init(arch, seed):
    """Every drawn leaf bitwise JAX's for the same key, the approximated
    leaves within INIT_ULPS; the tree is interop's layout."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    want = dict(_leaves(np_tree(jregistry.get_api(jcfg).init_params(
        jax.random.PRNGKey(seed), jcfg))))
    tree = tregistry.get_api(tcfg).init_params(prng.PRNGKey(seed, "cpu"),
                                               tcfg, device="cpu")
    got = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    approx = 0
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.rsplit("/", 1)[-1] in APPROX_LEAVES:
            assert ulp_gap(g, w) <= INIT_ULPS, name
            approx += 1
        else:
            assert np.array_equal(g, w), name
    shapes = interop.map_leaves(interop.lm_param_shapes(tcfg), tuple)
    assert interop.map_leaves(tree, lambda t: tuple(t.shape)) == shapes
    return approx


def _jax_greedy(jcfg, jp, prompts, new, M, emb):
    """JAX's greedy tokens through its registry's prefill / decode_step,
    the prompts left-padded as ARGenerator pads them.  (JAX's ARGenerator
    passes ``cache=`` to decode_step, which rwkv6's names ``state``, so it
    cannot serve the ssm family; the loop is its body.)"""
    api = jregistry.get_api(jcfg)
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, P - len(p):] = p
    cache = api.init_cache(jcfg, len(prompts), M)
    logits, cache = api.prefill(jp, jcfg, jnp.asarray(toks), cache,
                                **_kw(emb, jnp.asarray))
    out = []
    for _ in range(new):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(nxt))
        logits, cache = api.decode_step(jp, jcfg, nxt[:, None], cache)
    return np.stack(out, 1).tolist()


def check_argenerator(arch):
    """Greedy tokens of the port's ARGenerator equal JAX's for the same
    weights, prompts and embeddings (JAX's stub frames for an audio
    model)."""
    from repro_torch.models.vlm import stub_embeds
    from repro_torch.serving import ARGenerator, GenRequest
    jcfg, tcfg, jp, tp = pair(arch, seed=3)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (5, 7, 7)]
    emb = stub_embeds(tcfg, 3, "cpu")
    assert (emb is None) == (tcfg.family != "audio")
    M = 7 + 6
    want = _jax_greedy(jcfg, jp, prompts, 6, M,
                       None if emb is None else emb.numpy())
    tres = ARGenerator(tcfg, tp, batch_size=3, max_len=M,
                       device="cpu").generate(
        [GenRequest(prompt=p, max_new_tokens=6) for p in prompts],
        embeds=emb)
    assert [r.tokens.tolist() for r in tres] == want


# ------------------------------------------------------------ diffusion-LM
DLM_TOL = 1e-4      # of max|x0|: trunk forwards sum in another order


def dlm_pair(arch):
    from repro.diffusion_lm import model as jdlm
    from repro_torch.diffusion_lm import model as tdlm
    jcfg = jdlm.DiffusionLMConfig(arch=jconfigs.get_smoke(arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=configs.get_smoke(arch), time_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, interop.dlm_params_from_jax(np_tree(jp), tcfg)


def check_dlm_generate(arch):
    """The trunk carries no mega_spec in either package, so 'mega' runs
    the tile-resident loop (B1 per step on the card): x0 of one x_T
    against JAX's plan on the same x_T within DLM_TOL of max|x0|, and
    generate's tokens against the eager loop's."""
    from repro.core import make_schedule as j_make_schedule
    from repro.diffusion_lm import model as jdlm
    from repro.sampling import SamplerPlan as JPlan
    from repro_torch.core import SamplerConfig, make_schedule
    from repro_torch.diffusion_lm import model as tdlm
    from repro_torch.sampling import SamplerPlan, backends
    jcfg, tcfg, jp, tp = dlm_pair(arch)
    sch = make_schedule("linear", 1000)
    eps = tdlm.make_tile_eps_fn(tp, tcfg, 2, 64)
    assert getattr(eps, "mega_spec", None) is None
    jeps = jdlm.make_tile_eps_fn(jp, jcfg, 2, 64)
    assert not hasattr(jeps, "mega_spec")
    x_T = np.random.RandomState(5).randn(2, 64, 32).astype(np.float32)
    got = SamplerPlan.build(sch, 4).run(eps, torch.from_numpy(x_T),
                                        backend="mega")
    assert "mega_spec" in backends.run_mega.last_reason
    want = JPlan.build(j_make_schedule("linear", 1000), 4).run(
        jeps, jnp.asarray(x_T), backend="mega")
    close(got, want, DLM_TOL)
    kw = dict(sampler=SamplerConfig(S=4), device="cpu")
    a = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2, 64,
                      tile_resident=True, **kw)
    b = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2, 64, **kw)
    assert a.shape == (2, 64) and a.dtype == torch.int32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


LOSS_RTOL = 1e-5


def check_dlm_loss(arch):
    """training_loss of one key against JAX's (its t and eps), with and
    without remat; the gradients finite."""
    from repro.core import make_schedule as j_make_schedule
    from repro.diffusion_lm import model as jdlm
    from repro_torch.core import make_schedule
    from repro_torch.diffusion_lm import model as tdlm
    from repro_torch.training import steps as tsteps
    jcfg, tcfg, jp, tp = dlm_pair(arch)
    toks = tokens(1, 2, 16, tcfg.arch.vocab)
    jl, jaux = jdlm.training_loss(jp, jcfg, j_make_schedule("linear", 1000),
                                  jnp.asarray(toks), jax.random.PRNGKey(3))
    sch = make_schedule("linear", 1000)
    for remat in (True, False):
        (tl, taux), g = tsteps.value_and_grad(
            lambda p: tdlm.training_loss(p, tcfg, sch, torch.from_numpy(toks),
                                         prng.PRNGKey(3, "cpu"),
                                         remat=remat), tp)
        for got, want in ((tl, jl), (taux["l_eps"], jaux["l_eps"]),
                          (taux["l_round"], jaux["l_round"])):
            assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(
                float(want))
        assert all(bool(torch.isfinite(t).all())
                   for _, t in _leaves(g))


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()
