"""The port's training path (``repro_torch.training.steps``, the
diffusion-LM loss, ``launch.train``) against the JAX package's, on the CPU
at small widths, from converted weights and the same threefry key.

Tolerances:
  * the loss: LOSS_RTOL = 1e-5 (the forward agrees to ~1e-6 of scale, the
    mean over the batch carries that);
  * each gradient leaf: GRAD_FRAC = 1e-3 of that leaf's max|g| (the
    backward carries the forward's float32 differences through every
    layer; measured ~1e-5);
  * the gradient norm: GNORM_RTOL = 1e-4;
  * new parameters only through the optimizer fed JAX's gradients, at 4
    ulps of each leaf's max|p|: at step 1 Adam's g / (|g| + eps) turns the
    tiny gradient differences above into sign-sized steps, so params from
    the two backwards are not comparable;
  * keys and data: bitwise.

JAX's side runs under ``jax.jit`` (its train steps, gradients and losses
are jitted here, one compilation each, instead of dispatched op by op),
and where the weights reach the port through ``interop`` its init is
jitted too: the same functions, compiled.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro import core as jcore
from repro.diffusion_lm import model as jdlm
from repro.models import dense as jdense
from repro.models import unet as junet
from repro.training import checkpoint as jckpt
from repro.training import optim as jopt
from repro.training import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import core as tcore
from repro_torch import interop, prng
from repro_torch.data import SyntheticImages, SyntheticTokens
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import dense as tdense
from repro_torch.models import unet as tunet
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optim as topt
from repro_torch.training import steps as tsteps

LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-3
GNORM_RTOL = 1e-4
ULPS = 4
F32_EPS = float(np.finfo(np.float32).eps)
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)
UCFG = dict(in_channels=3, base_width=16, width_mults=(1, 2),
            n_res_blocks=1, attn_levels=(1,), time_dim=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _u32(k):
    return np.asarray(k).astype(np.int64)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_grads_close(tg: dict, jg: dict):
    assert sorted(tg) == sorted(jg)
    for k in jg:
        w = jg[k].numpy() if torch.is_tensor(jg[k]) else np.asarray(jg[k])
        g = tg[k].numpy()
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_FRAC * scale, k


def _assert_params_close(tp: dict, jp: dict):
    for k in jp:
        w = jp[k].numpy()
        tol = ULPS * F32_EPS * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(tp[k].numpy() - w).max()) <= tol, k


# ------------------------------------------------------- diffusion step
@pytest.fixture(scope="module")
def unet_pair():
    """A small U-Net (two levels, attention at level 1) on both sides:
    the JAX init redrawn at fan-in scale, carried over by ``interop``."""
    jcfg, tcfg = junet.UNetConfig(**UCFG), tunet.UNetConfig(**UCFG)
    tree = jax.jit(lambda k: junet.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (rs.randn(*np.shape(a)) / np.sqrt(np.prod(np.shape(a)[:-1]))
                   if np.ndim(a) > 1 else np.asarray(a)).astype(np.float32),
        tree)
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(tree, tcfg))
    return jcfg, tcfg, tree, model


def _unet_losses(jcfg, model):
    def jloss(params, batch, rng):
        def eps(x, t):
            return junet.forward(params, jcfg, x, t)
        return jcore.training_loss(JSCH, eps, batch, rng), {}

    tloss = tsteps.module_loss(model, lambda eps_fn, batch, rng: (
        tcore.training_loss(TSCH, eps_fn, batch, rng), {}))
    return jloss, tloss


def test_diffusion_train_step_matches_jax(unet_pair):
    jcfg, tcfg, tree, model = unet_pair
    jloss, tloss = _unet_losses(jcfg, model)
    batch = SyntheticImages(size=8).sample(prng.PRNGKey(4, "cpu"), 3)
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt = topt.AdamWConfig(lr=1e-3)
    jopt_cfg = jopt.AdamWConfig(lr=1e-3)
    state = tsteps.init_train_state(params, prng.PRNGKey(1, "cpu"), opt)
    jstate = jsteps.init_train_state(tree, jax.random.PRNGKey(1), jopt_cfg)
    new, metrics = tsteps.make_diffusion_train_step(tloss, opt)(state, batch)
    jnew, jmetrics = jax.jit(jsteps.make_diffusion_train_step(
        jloss, jopt_cfg))(jstate, jnp.asarray(batch.numpy()))
    np.testing.assert_array_equal(new.rng.numpy(), _u32(jnew.rng))
    assert _rel(metrics["loss"], jmetrics["loss"]) <= LOSS_RTOL
    assert _rel(metrics["grad_norm"], jmetrics["grad_norm"]) <= GNORM_RTOL
    assert int(new.opt.step) == 1
    # the gradients of the step's loss at the step's key
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree, jnp.asarray(batch.numpy()), sub)
    (tl, _), tg = tsteps.value_and_grad(tloss, params, batch,
                                        torch.from_numpy(_u32(sub)))
    assert _rel(tl, jl) <= LOSS_RTOL
    jg_t = interop.unet_params_from_jax(_np(jg), tcfg)
    _assert_grads_close(tg, jg_t)
    # new params: the port's AdamW on JAX's gradients against JAX's step
    tp, _, _ = topt.adamw_update(opt, jg_t, topt.adamw_init(params), params)
    jp = interop.unet_params_from_jax(_np(jnew.params), tcfg)
    _assert_params_close(tp, jp)


def test_ema_weights_load_back_into_a_unet(unet_pair):
    """Params, grads, optimizer state and EMA are dicts keyed like the
    module's parameters; the EMA dict loads back into a UNet to serve."""
    _, tcfg, _, model = unet_pair
    params = {k: v.detach() for k, v in model.named_parameters()}
    ema = topt.ema_update(topt.ema_init(params), params, 0.999)
    fresh = tunet.UNet(tcfg, device="cpu")
    fresh.load_state_dict({**model.state_dict(), **ema})
    for k, v in ema.items():
        assert torch.equal(fresh.state_dict()[k], v)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 8, 3).astype(
        np.float32))
    t = torch.full((1,), 10, dtype=torch.int32)
    with torch.no_grad():
        want = torch.func.functional_call(model, ema, (x, t))
        torch.testing.assert_close(fresh(x, t), want, rtol=0, atol=0)


# ------------------------------------------------------------- LM step
@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jconfigs.get_smoke("smollm-135m")
    tcfg = tconfigs.get_smoke("smollm-135m")
    jp = jax.jit(lambda k: jdense.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tp = interop.lm_params_from_jax(_np(jp), tcfg)
    tokens = SyntheticTokens(vocab=tcfg.vocab).sample(
        prng.PRNGKey(2, "cpu"), 4, 24)
    return jcfg, tcfg, jp, tp, tokens


@pytest.mark.parametrize("accum", [1, 2], ids=str)
def test_lm_train_step_matches_jax(lm_pair, accum):
    jcfg, tcfg, jp, tp, tokens = lm_pair
    opt, jopt_cfg = topt.AdamWConfig(lr=1e-3), jopt.AdamWConfig(lr=1e-3)
    state = tsteps.init_train_state(tp, prng.PRNGKey(1, "cpu"), opt)
    jstate = jsteps.init_train_state(jp, jax.random.PRNGKey(1), jopt_cfg)
    new, m = tsteps.make_lm_train_step(tcfg, opt, accum_steps=accum)(
        state, {"tokens": tokens})
    jnew, jm = jax.jit(jsteps.make_lm_train_step(
        jcfg, jopt_cfg, accum_steps=accum))(
        jstate, {"tokens": jnp.asarray(tokens.numpy())})
    np.testing.assert_array_equal(new.rng.numpy(), _u32(jnew.rng))
    assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= GNORM_RTOL
    if accum == 1:
        api = tsteps.get_api(tcfg)
        (_, _), tg = tsteps.value_and_grad(
            lambda p: tsteps.lm_loss_fn(api, tcfg, p, tokens, None), tp)
        from repro.models import get_api as jget_api
        japi = jget_api(jcfg)
        (_, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jsteps.lm_loss_fn(japi, jcfg, p,
                                        jnp.asarray(tokens.numpy()), None),
            has_aux=True))(jp)
        flat = lambda tree: {"/".join(p): v for p, v in  # noqa: E731
                             tckpt._flatten(tree)}
        _assert_grads_close(flat(tg), flat(_np(jg)))
        jg_t = interop.lm_params_from_jax(_np(jg), tcfg)
        p1, _, _ = topt.adamw_update(opt, jg_t, topt.adamw_init(tp), tp)
        _assert_params_close(flat(p1), flat(interop.lm_params_from_jax(
            _np(jnew.params), tcfg)))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "llava-next-mistral-7b", "zamba2-2.7b",
                                  "rwkv6-7b", "seamless-m4t-large-v2"])
def test_lm_train_step_other_families_match_jax(arch):
    """A moe step adds aux_weight * aux (MLA and GQA); a vlm or audio
    step trains on JAX's stub embeddings; the hybrid and ssm steps run
    autograd through the chunked SSD and the WKV loop; loss, aux and grad
    norm as JAX's.  Both sides train JAX's (jitted) init, carried over by
    ``interop`` (``test_torch_init.py`` holds the port's init bitwise to
    JAX's)."""
    from repro.models import get_api as jget_api
    from repro_torch.models.vlm import stub_embeds
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jax.jit(lambda k: jget_api(jcfg).init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tp = interop.lm_params_from_jax(_np(jp), tcfg)
    tokens = SyntheticTokens(vocab=tcfg.vocab).sample(
        prng.PRNGKey(2, "cpu"), 2, 16)
    batch, jbatch = {"tokens": tokens}, {"tokens": jnp.asarray(
        tokens.numpy())}
    emb = stub_embeds(tcfg, 2, "cpu")
    if emb is not None:
        batch["embeds"] = emb
        jbatch["embeds"] = jax.random.normal(
            jax.random.PRNGKey(9), (2, jcfg.n_ctx_embeds, jcfg.d_model)) \
            * 0.02
        np.testing.assert_array_equal(emb.numpy(), np.asarray(
            jbatch["embeds"]))
    opt, jopt_cfg = topt.AdamWConfig(lr=1e-3), jopt.AdamWConfig(lr=1e-3)
    _, m = tsteps.make_lm_train_step(tcfg, opt)(
        tsteps.init_train_state(tp, prng.PRNGKey(1, "cpu"), opt), batch)
    _, jm = jax.jit(jsteps.make_lm_train_step(jcfg, jopt_cfg))(
        jsteps.init_train_state(jp, jax.random.PRNGKey(1), jopt_cfg),
        jbatch)
    assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= GNORM_RTOL
    if tcfg.family == "moe":
        assert float(m["aux"]) > 0.0
        assert _rel(m["aux"], jm["aux"]) <= LOSS_RTOL


def test_lm_accum_two_agrees_with_one(lm_pair):
    _, tcfg, _, tp, tokens = lm_pair
    opt = topt.AdamWConfig(lr=1e-3)
    out = [tsteps.make_lm_train_step(tcfg, opt, accum_steps=a)(
        tsteps.init_train_state(tp, prng.PRNGKey(1, "cpu"), opt),
        {"tokens": tokens})[1] for a in (1, 2)]
    assert _rel(out[1]["loss"], out[0]["loss"]) <= LOSS_RTOL
    assert _rel(out[1]["grad_norm"], out[0]["grad_norm"]) <= GNORM_RTOL


def test_prefill_and_decode_steps_are_the_api():
    cfg = tconfigs.get_smoke("smollm-135m")
    params = tdense.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    tok = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    cache = tdense.init_cache(cfg, 1, 8, device="cpu")
    logits, cache = tsteps.make_prefill_step(cfg)(params, tok, cache)
    want, _ = tdense.prefill(params, cfg, tok,
                             tdense.init_cache(cfg, 1, 8, device="cpu"))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt, _ = tsteps.make_decode_step(cfg)(params, tok[:, :1], cache)
    assert nxt.shape[-1] == cfg.vocab


# ------------------------------------------------------ diffusion-LM loss
def test_diffusion_lm_training_loss_matches_jax():
    """The same key gives JAX's (t, eps); the loss terms within
    LOSS_RTOL; remat changes no number."""
    arch = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=50)
    from repro.models.common import ArchConfig as JArch
    from repro_torch.models.common import ArchConfig as TArch
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32)
    jp = jax.jit(lambda k: jdlm.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = interop.dlm_params_from_jax(_np(jp), tcfg)
    tokens = np.random.RandomState(1).randint(0, 50, (2, 16)).astype(
        np.int32)
    jl, jaux = jax.jit(lambda p, t, k: jdlm.training_loss(
        p, jcfg, JSCH, t, k))(jp, jnp.asarray(tokens), jax.random.PRNGKey(3))
    losses = []
    for remat in (True, False):
        (tl, taux), g = tsteps.value_and_grad(
            lambda p: tdlm.training_loss(p, tcfg, TSCH,
                                         torch.from_numpy(tokens),
                                         prng.PRNGKey(3, "cpu"),
                                         remat=remat), tp)
        losses.append((tl, g))
        assert _rel(tl, jl) <= LOSS_RTOL
        for k in ("l_eps", "l_round"):
            assert _rel(taux[k], jaux[k]) <= LOSS_RTOL
    assert torch.equal(losses[0][0], losses[1][0])
    for a, b in zip(topt.tree_leaves(losses[0][1]),
                    topt.tree_leaves(losses[1][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ CLI
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_train_unet_cli_checkpoint_restores_in_jax(tmp_path):
    lines = _run(ttrain.main, [
        "--arch", "unet", "--steps", "2", "--batch", "2", "--image-size",
        "8", "--log-every", "1", "--ckpt-dir", str(tmp_path), "--device",
        "cpu"])
    assert lines[0].startswith("U-Net params: ") and "T=1000" in lines[0]
    assert lines[1].startswith("step     1 loss=")
    assert lines[-1].startswith("final checkpoint: ")
    path = lines[-1].split(": ", 1)[1]
    like = jax.tree.map(np.asarray, junet.init_params(
        jax.random.PRNGKey(0), jconfigs.TOY_UNET))
    restored, meta = jckpt.restore(path, {"params": like, "ema": like})
    assert meta["step"] == 2
    ema = interop.unet_params_from_jax(restored["ema"], tconfigs.TOY_UNET)
    params = interop.unet_params_from_jax(restored["params"],
                                          tconfigs.TOY_UNET)
    assert any(not torch.equal(ema[k], params[k]) for k in ema)
    served = _run(tserve.main, [
        "--arch", "unet", "--ckpt", path, "--S", "3", "--n-samples", "2",
        "--batch", "2", "--image-size", "8", "--device", "cpu"])
    assert served[0].startswith("sampled (2, 8, 8, 3) in 1 batches")


def test_train_lm_cli_smoke_and_refusals(tmp_path):
    lines = _run(ttrain.main, [
        "--arch", "smollm-135m", "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert lines[0].startswith("smollm-135m-smoke: ")
    last = json.loads(lines[-1])
    assert set(last) == {"first_loss", "last_loss"}
    like = jax.tree.map(np.asarray, jdense.init_params(
        jax.random.PRNGKey(0), jconfigs.get_smoke("smollm-135m")))
    restored, _ = jckpt.restore(jckpt.latest(str(tmp_path)),
                                {"params": like})
    assert jax.tree.structure(restored["params"]) == jax.tree.structure(like)
    for arch in ("rwkv6-7b", "seamless-m4t-large-v2"):
        lines = _run(ttrain.main, ["--arch", arch, "--smoke", "--steps", "1",
                                   "--batch", "2", "--seq", "16",
                                   "--device", "cpu"])
        assert lines[0].startswith(f"{arch}-smoke: ")
        assert set(json.loads(lines[-1])) == {"first_loss", "last_loss"}
