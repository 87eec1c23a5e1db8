"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/``), each run on the CPU below its ``--smoke``
budget (a few train steps, small n, short trajectories).

Tolerances:
  * ``init_mlp`` and ``discrete_ddim.init_model``: bitwise JAX's for the
    same key.
  * ``mlp_eps`` / ``x0_fn``: within 4 float32 ulps of max(|output|, 1) on
    the same (converted) weights, x and t.
  * Each example's printed run: JAX's lines, line for line, by the rule
    of ``tests/_torch_examples.py`` (text exact; every number within 2
    units of the last digit JAX printed plus 1e-4 of its size; walls and
    latencies masked; JAX's ``jnp`` backend is the port's ``eager``).
    The two packages train with the same threefry draws and AdamW, JAX
    under ``jit`` and the port eagerly, so the numbers differ by float32
    rounding only.
  * The in-process ``gateway_sse``: every stream has previews and a
    result, and its lines are JAX's.
"""
import argparse
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_examples import assert_same_lines, jax_example
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch import prng
from repro_torch.examples import (discrete_ddim, gateway_sse, interpolation,
                                  quickstart, reconstruction)

F32_ULP = 2.0 ** -23


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 3])
def test_init_mlp_bitwise(seed):
    want = _np_tree(jax_example("quickstart").init_mlp(
        jax.random.PRNGKey(seed)))
    got = quickstart.init_mlp(prng.PRNGKey(seed, "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("seed", [0, 3])
def test_discrete_init_model_bitwise(seed):
    want = _np_tree(jax_example("discrete_ddim").init_model(
        jax.random.PRNGKey(seed)))
    got = discrete_ddim.init_model(prng.PRNGKey(seed, "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def _ulp_check(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    tol = 4 * F32_ULP * max(float(np.abs(want).max()), 1.0)
    assert np.abs(got.numpy() - want).max() <= tol


def test_mlp_eps_matches_jax():
    jq = jax_example("quickstart")
    rs = np.random.RandomState(0)
    jp = {k: v + 0.1 * rs.randn(*v.shape).astype(np.float32)
          for k, v in _np_tree(jq.init_mlp(jax.random.PRNGKey(1))).items()}
    x = rs.randn(32, 2).astype(np.float32)
    t = rs.randint(1, 1001, 32).astype(np.int32)
    want = jq.mlp_eps({k: jnp.asarray(v) for k, v in jp.items()},
                      jnp.asarray(x), jnp.asarray(t), 1000)
    got = quickstart.mlp_eps({k: torch.from_numpy(v) for k, v in jp.items()},
                             torch.from_numpy(x), torch.from_numpy(t), 1000)
    _ulp_check(got, want)


def test_x0_fn_matches_jax():
    jd = jax_example("discrete_ddim")
    rs = np.random.RandomState(1)
    jp = {k: v + 0.1 * rs.randn(*v.shape).astype(np.float32)
          for k, v in _np_tree(jd.init_model(jax.random.PRNGKey(2))).items()}
    x = np.eye(jd.K, dtype=np.float32)[rs.randint(0, jd.K, 32)]
    t = rs.randint(1, 101, 32).astype(np.int32)
    want = jd.x0_fn({k: jnp.asarray(v) for k, v in jp.items()},
                    jnp.asarray(x), jnp.asarray(t), 100)
    got = discrete_ddim.x0_fn({k: torch.from_numpy(v) for k, v in jp.items()},
                              torch.from_numpy(x), torch.from_numpy(t), 100)
    _ulp_check(got, want)


QUICK_GMM = dict(steps=3, steps_list=[3], n_samples=64)
QUICK_IMAGES = dict(steps=2, steps_list=[2], batch=4)


@pytest.mark.parametrize("preset", ["gmm", "images"])
def test_quickstart_prints_jaxs_lines(preset, capsys):
    kw = QUICK_GMM if preset == "gmm" else QUICK_IMAGES
    argv = ["--preset", preset, "--device", "cpu"]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] + ([str(x) for x in v] if isinstance(v, list)
                          else [str(v)])
    args = quickstart.parse_args(argv)
    jq = jax_example("quickstart")
    jargs = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                  if k != "device"})
    (jq.run_gmm if preset == "gmm" else jq.run_images)(jargs)
    jout = capsys.readouterr().out
    res = quickstart.main(argv)
    assert_same_lines(jout, capsys.readouterr().out)
    assert res["preset"] == preset and len(res["rows"]) == (
        7 if preset == "gmm" else 2)
    if preset == "gmm":
        assert res["backend_delta"] == {"tile_resident": 0.0, "rows": 0.0}


def test_quickstart_smoke_budget_is_jaxs():
    args = quickstart.parse_args(["--smoke"])
    assert (args.steps, args.steps_list, args.n_samples) == (60, [5], 512)
    assert quickstart.parse_args(["--preset", "images"]).steps == 300
    assert quickstart.parse_args([]).device == "cuda"


def test_interpolation_prints_jaxs_lines(capsys):
    jax_example("interpolation").main(
        argparse.Namespace(steps=3, S=5, n_interp=4))
    jout = capsys.readouterr().out
    res = interpolation.main(["--steps", "3", "--S", "5", "--n-interp", "4",
                              "--device", "cpu"])
    assert_same_lines(jout, capsys.readouterr().out)
    assert res["decode_S"] == 5 and res["path"].shape == (4, 2)
    assert res["ddim_spread"] == 0.0 and res["ddpm_spread"] > 0.0


def test_reconstruction_prints_jaxs_lines(capsys):
    jax_example("reconstruction").main(
        argparse.Namespace(steps=3, n=32, S_list=[5, 10, 20]))
    jout = capsys.readouterr().out
    res = reconstruction.main(["--steps", "3", "--n", "32", "--S-list", "5",
                               "10", "20", "--device", "cpu"])
    assert_same_lines(jout, capsys.readouterr().out)
    assert [r[0] for r in res["rows"]] == [5, 10, 20]


def test_discrete_ddim_prints_jaxs_lines(capsys):
    jax_example("discrete_ddim").main(
        argparse.Namespace(steps=3, T=100, n=256, S_list=[5, 10]))
    jout = capsys.readouterr().out
    res = discrete_ddim.main(["--steps", "3", "--n", "256", "--S-list", "5",
                              "10", "--device", "cpu"])
    assert_same_lines(jout, capsys.readouterr().out)
    assert len(res["rows"]) == 6


def test_gateway_sse_in_process_streams(capsys):
    """The in-process two-model gateway on the CPU: every stream has
    previews and a result, and the lines are JAX's example's."""
    asyncio.run(jax_example("gateway_sse").run_in_process(8))
    jout = capsys.readouterr().out
    res = gateway_sse.main(["--S", "8", "--smoke", "--device", "cpu"])
    tout = capsys.readouterr().out
    assert_same_lines(jout + "gateway sse example: OK\n", tout)
    assert res["ok"] and res["rc"] == 0
    assert sorted(res["streams"]) == ["alt", "base"]
    for tally in res["streams"].values():
        assert tally["previews"] > 0 and tally["result"] is not None
        assert tally["error"] is None
    assert res["stats"]["results_streamed"] == 2


def test_gateway_sse_names_aiohttp_when_missing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_aiohttp(name, *a, **kw):
        if name == "aiohttp":
            raise ImportError("no aiohttp")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_aiohttp)
    with pytest.raises(RuntimeError, match="aiohttp"):
        gateway_sse.main(["--device", "cpu"])


@pytest.mark.parametrize("name", ["quickstart", "interpolation",
                                  "reconstruction", "discrete_ddim",
                                  "lm_diffusion", "gateway_sse"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Every example runs on CUDA unless asked for --device cpu: without a
    card its default raises before any work."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
