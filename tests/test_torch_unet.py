"""The port's U-Net against the JAX U-Net, weights carried by interop.

Every leaf of the JAX init tree is overwritten with numpy normals at
fan-in scale before the comparison: the JAX init starts conv2, wo and
conv_out at 1e-10, which would make eps ~1e-9 and prove nothing.

Tolerance: |port - jax| <= 1e-4 * max|jax| + 1e-6 in float32 — both sides
run float32 convolutions and matmuls, summed in different orders
(measured 7e-7 of max|jax| at this size on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.models import unet as junet
from repro_torch import interop, prng
from repro_torch.configs import CIFAR10_UNET, TOY_UNET
from repro_torch.models import unet as tunet

SMALL = tunet.UNetConfig(in_channels=3, base_width=16, width_mults=(1, 2),
                         n_res_blocks=1, attn_levels=(1,), time_dim=32)
RTOL_OF_SCALE = 1e-4


def _jcfg(cfg):
    return junet.UNetConfig(**{f: getattr(cfg, f) for f in (
        "in_channels", "base_width", "width_mults", "n_res_blocks",
        "attn_levels", "time_dim", "groups")})


def _random_tree(cfg, seed=0):
    """The JAX init tree with every leaf redrawn: normals at fan-in scale
    for matrices and kernels, N(1, 0.1) / N(0, 0.1) for 1-D leaves."""
    tree = junet.init_params(jax.random.PRNGKey(seed), _jcfg(cfg))
    rs = np.random.RandomState(seed)

    def redraw(path, leaf):
        shape = np.shape(leaf)
        if len(shape) == 1:
            scale = str(path[-1].key).endswith("_s")      # GroupNorm scale
            return (float(scale) + rs.randn(*shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _port_model(cfg, tree):
    model = tunet.UNet(cfg, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(tree, cfg))
    return model.eval()


def _assert_close(got, want):
    want = np.asarray(want)
    tol = RTOL_OF_SCALE * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("hw", [8, 16])
def test_unet_forward_matches_jax(hw):
    tree = _random_tree(SMALL)
    rs = np.random.RandomState(hw)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    t = np.array([1, 777], np.int32)
    want = junet.forward(tree, _jcfg(SMALL), jnp.asarray(x), jnp.asarray(t))
    model = _port_model(SMALL, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, hw, hw, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0.1   # eps is O(1)
    _assert_close(got.numpy(), want)


def test_stride2_downsample_needs_same_padding():
    """XLA "SAME" at stride 2 pads 0 before / 1 after; symmetric padding=1
    gives another result, which the port must not use."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 16) / 12.0).astype(np.float32)
    want = np.asarray(junet.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    same = torch.nn.functional.conv2d(tunet.same_pad(xt, 3, 2), wt, stride=2)
    _assert_close(same.permute(0, 2, 3, 1).numpy(), want)
    sym = torch.nn.functional.conv2d(xt, wt, stride=2, padding=1)
    err = float(np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max())
    assert err > 100 * RTOL_OF_SCALE * float(np.abs(want).max())


def test_time_embedding_matches_jax():
    from repro.models.common import sinusoidal_time_embedding as jemb
    from repro_torch.models.common import sinusoidal_time_embedding as temb
    # cos/sin arguments reach t ~ 1e3 rad, so one ulp of a frequency from
    # the two frameworks' exp moves them by up to ~6e-5
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (16, 33, 128):
        np.testing.assert_allclose(
            temb(torch.from_numpy(t), dim).numpy(),
            np.asarray(jemb(jnp.asarray(t), dim)), rtol=0, atol=1e-4)


def test_interop_rejects_unmapped_and_misshapen_leaves():
    tree = _random_tree(SMALL)
    bad = dict(tree, extra_leaf=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra_leaf"):
        interop.unet_params_from_jax(bad, SMALL)
    bad = dict(tree, conv_in=np.zeros((3, 3, 3, 8), np.float32))
    with pytest.raises(ValueError, match="conv_in"):
        interop.unet_params_from_jax(bad, SMALL)
    bad = {k: v for k, v in tree.items() if k != "conv_out"}
    with pytest.raises(KeyError, match="conv_out"):
        interop.unet_params_from_jax(bad, SMALL)


@pytest.mark.parametrize("cfg", [SMALL, TOY_UNET, CIFAR10_UNET],
                         ids=["small", "toy", "cifar10"])
def test_port_init_matches_jax_parameter_shapes(cfg):
    """The port's own init covers the same parameters as the JAX init
    (shapes via interop of the JAX shape tree), with 1e-10 leaves."""
    shapes = jax.eval_shape(
        lambda: junet.init_params(jax.random.PRNGKey(0), _jcfg(cfg)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    expected = interop.unet_params_from_jax(zeros, cfg)
    model = tunet.UNet(cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in expected.items()}
    if cfg is SMALL:
        m = tunet.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
        sd = m.state_dict()
        assert float(sd["conv_out.weight"].abs().max()) < 1e-9
        w = sd["conv_in.weight"]
        assert 0.5 < float(w.std() * np.sqrt(w[0].numel())) < 1.5
        assert float(sd["gn_out.weight"].min()) == 1.0


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tunet.UNet(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tunet.init_params(prng.PRNGKey(0, "cpu"), SMALL)
