"""The port's serving CLI (``repro_torch.launch.serve``) and checkpoint
files (``repro_torch.training.checkpoint``) on the CPU.

The CLI runs through ``main([..., "--device", "cpu"])`` at its defaults
(``TOY_UNET``, 16 x 16 images): the ``--scheduler`` replay prints JAX's
per-request lines (each request's plan is the JAX ``SamplerPlan`` of the
same rule, compared by its printed form), ``--pools`` with every telemetry
flag writes its files, ``--gateway --smoke`` round-trips a live aiohttp
client, and ``--ckpt`` serves a checkpoint that the JAX package saved.

Checkpoint files cross packages in both directions: a JAX U-Net
``{"params", "ema"}`` file restores in the port and, through
``repro_torch.interop``, gives the state dict converted from the JAX
leaves, bitwise; a file the port writes from its state dict restores in
the JAX package to the original JAX leaves, bitwise (every conversion is
a transpose).  The CLI's samples from such a file equal a service built
on the converted weights, bitwise (same code, same seed).
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import make_schedule as j_make_schedule
from repro.models import unet as junet
from repro.sampling import SamplerPlan as JPlan
from repro.sampling import SigmaSpec as JSigma
from repro.sampling import TauSpec as JTau
from repro.training import checkpoint as jckpt
from repro_torch import configs, interop
from repro_torch.core import make_schedule
from repro_torch.launch import serve
from repro_torch.models import unet
from repro_torch.sampling import SamplerPlan, TauSpec
from repro_torch.serving import DiffusionSampler
from repro_torch.serving.gateway import HAVE_HTTP
from repro_torch.training import checkpoint

CPU = ["--arch", "unet", "--device", "cpu"]
LINE = re.compile(r"^req(\d+): (SamplerPlan\(.*\)) wait=[\d.]+ms "
                  r"service=[\d.]+ms latency=[\d.]+ms$")


_J_SHAPES = jax.eval_shape(
    lambda k: junet.init_params(k, jconfigs.TOY_UNET), jax.random.PRNGKey(0))


def _jax_unet(seed):
    """A JAX U-Net pytree (JAX's own nesting, names and layouts, from
    ``eval_shape`` of its ``init_params``) with seeded float32 leaves (the
    init itself runs op by op for ~15 s on this CPU)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) * 0.05).astype(np.float32), _J_SHAPES)


def _jax_plan(i, s_mix, tau, order, sch):
    """The plan JAX's ``serve_unet_continuous`` gives request ``i``."""
    S = s_mix[i % len(s_mix)]
    spacing = (JTau.quadratic(S) if tau == "quadratic"
               or (tau == "mix" and i % 2) else JTau.uniform(S))
    return JPlan.build(sch, tau=spacing, sigma=JSigma.from_eta(0.0),
                       order=order if order > 1 and i % 3 == 0 else 1)


# ------------------------------------------------------------------ CLI
def test_scheduler_cli_prints_jax_lines(capsys):
    serve.main(CPU + ["--scheduler", "--slots", "4", "--s-mix", "4,6,8",
                      "--tau", "mix", "--order", "2", "--n-samples", "6"])
    out = capsys.readouterr().out.splitlines()
    reqs = [LINE.match(line) for line in out if re.match(r"req\d+:", line)]
    assert len(reqs) == 6 and all(reqs)
    sch = j_make_schedule("linear", T=1000)
    for m in reqs:
        i = int(m.group(1))
        assert m.group(2) == repr(_jax_plan(i, (4, 6, 8), "mix", 2, sch))
    text = "\n".join(out)
    assert "=== replay summary ===" in text
    assert re.search(r"completed\s+6", text)
    assert re.search(r"active\s+0/4\s+0\s+\d+ .* multistep", text)


def test_fleet_cli_with_telemetry_files(tmp_path, capsys):
    trace, prom, flight = (tmp_path / "t.jsonl", tmp_path / "m.prom",
                           tmp_path / "flight")
    serve.main(CPU + ["--scheduler", "--pools", "2", "--slots", "2",
                      "--s-mix", "3,4", "--n-samples", "4", "--eta", "1",
                      "--probes", "--flight-dir", str(flight), "--profile",
                      "--trace-out", str(trace), "--prom-out", str(prom)])
    out = capsys.readouterr().out.splitlines()
    pools = [re.match(r"^req(\d+): S=(\d+) pool=(\d) wait=", line)
             for line in out if re.match(r"req\d+:", line)]
    assert [(int(m.group(1)), int(m.group(2))) for m in pools] == [
        (0, 3), (1, 4), (2, 3), (3, 4)]
    assert {int(m.group(3)) for m in pools} <= {0, 1}
    assert prom.read_text().count('pool="1"') > 0
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert sorted(e["req"] for e in events if e["ev"] == "retire") == [
        -2, -1, 0, 1, 2, 3]              # the warm-up requests, then ours
    assert sorted(p.name.split("-")[0] for p in flight.iterdir()) == [
        "flight_pool0_replay", "flight_pool1_replay"]
    assert sum(line.startswith("flight ") for line in out) == 2


def test_lockstep_cli_and_out(tmp_path, capsys):
    path = tmp_path / "x.npy"
    serve.main(CPU + ["--S", "4", "--n-samples", "3", "--tau",
                      "quadratic", "--out", str(path)])
    out = capsys.readouterr().out
    assert re.search(r"^sampled \(3, 16, 16, 3\) in 1 batches; steady=",
                     out, re.M)
    assert "SamplerPlan(S=4, tau=quadratic, sigma=eta(eta=0), T=1000)" \
        in out
    assert np.load(path).shape == (3, 16, 16, 3)


def test_ckpt_from_jax_serves_its_ema(tmp_path):
    """--ckpt with a file the JAX package saved: the lockstep samples are
    those of a service on the EMA weights converted by interop."""
    path = str(tmp_path / "ckpt.npz")
    jckpt.save(path, {"params": _jax_unet(1), "ema": _jax_unet(2)},
               step=300)
    out = tmp_path / "x.npy"
    serve.main(CPU + ["--ckpt", path, "--S", "3", "--n-samples", "2",
                      "--seed", "5", "--out", str(out)])
    model = unet.UNet(configs.TOY_UNET, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(_jax_unet(2),
                                                       configs.TOY_UNET))
    svc = DiffusionSampler(make_schedule("linear", T=1000),
                           unet.make_eps_fn(model.eval()), (16, 16, 3),
                           batch_size=4, device="cpu")
    want, _ = svc.serve(2, SamplerPlan.build(
        svc.schedule, tau=TauSpec.uniform(3), sigma=0.0), seed=5)
    assert np.array_equal(np.load(out), want.numpy())


@pytest.mark.skipif(not HAVE_HTTP, reason="aiohttp not installed")
def test_gateway_smoke_cli(capsys):
    serve.main(CPU + ["--gateway", "--smoke", "--slots", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^gateway smoke: models=\['alt', 'base'\] json\+sse "
                     r"round-trips previews=2 requests=2 \(OK\)$", out, re.M)


def test_gateway_needs_the_transport(monkeypatch):
    import repro_torch.serving.gateway as gw
    monkeypatch.setattr(gw, "HAVE_HTTP", False)
    with pytest.raises(SystemExit, match="requires aiohttp"):
        serve.main(CPU + ["--gateway", "--smoke"])


def test_refusals_and_unported_arch(monkeypatch):
    with pytest.raises(NotImplementedError,
                       match="repro/serving/engine.py::ARGenerator"):
        serve.main(["--arch", "smollm-135m", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "smollm-135m", "--gateway"])
    with pytest.raises(SystemExit):
        serve.main(CPU + ["--order", "2", "--eta", "0.5"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "unet", "--S", "2", "--n-samples", "1"])


# ------------------------------------------------------------ checkpoint
def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(np.array_equal(np.asarray(x), np.asarray(y))
                            for x, y in zip(la, lb))


def test_checkpoint_files_cross_packages_both_ways(tmp_path):
    cfg = configs.TOY_UNET
    j_params, j_ema = _jax_unet(3), _jax_unet(4)
    # JAX -> port
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, {"params": j_params, "ema": j_ema}, step=7)
    like = interop.unet_params_to_jax(unet.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu").state_dict(),
        cfg)
    got, meta = checkpoint.restore(jpath, {"params": like, "ema": like})
    assert meta == {"step": 7, "n_leaves": 2 * len(
        jax.tree_util.tree_leaves(j_ema))}
    for name, tree in (("params", j_params), ("ema", j_ema)):
        sd = interop.unet_params_from_jax(got[name], cfg)
        want = interop.unet_params_from_jax(tree, cfg)
        assert all(torch.equal(sd[k], want[k]) for k in want)
    # port -> JAX: the port's state dict in the JAX layout
    sd = interop.unet_params_from_jax(j_ema, cfg)
    tpath = str(tmp_path / "port.npz")
    checkpoint.save(tpath, {"params": interop.unet_params_to_jax(sd, cfg),
                            "ema": interop.unet_params_to_jax(sd, cfg)},
                    step=9)
    back, meta = jckpt.restore(tpath, {"params": j_params, "ema": j_params})
    assert meta["step"] == 9
    assert _leaves_equal(back["ema"], j_ema)
    assert _leaves_equal(back["params"], j_ema)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert a.files == b.files            # same index|path keys


def test_checkpoint_tensor_trees_dtypes_and_refusals(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(3, dtype=torch.bfloat16),
                  torch.tensor([1, 2], dtype=torch.int32)],
            "t": (np.float32(2.5) * np.ones((1,), np.float32),)}
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, tree, step=1)
    with np.load(path) as data:
        assert data["00000|b/0"].dtype == np.float32   # bf16 stored f32
        assert sorted(data.files) == ["00000|b/0", "00001|b/1",
                                      "00002|t/0", "00003|w", "__meta__"]
    got, meta = checkpoint.restore(path, tree)
    assert meta == {"step": 1, "n_leaves": 4}
    assert got["b"][0].dtype == torch.bfloat16 and torch.equal(
        got["b"][0], tree["b"][0])
    assert torch.equal(got["w"], tree["w"]) and isinstance(got["t"], tuple)
    jgot, _ = jckpt.restore(path, jax.tree_util.tree_map(
        lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor)
                             else x), tree))
    assert np.array_equal(np.asarray(jgot["w"]), tree["w"].numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, dict(tree, w=torch.zeros(3, 2)))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, {"w": tree["w"]})


def test_checkpoint_save_step_keeps_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert checkpoint.latest(d) is None
    for step in (1, 2, 3, 10):
        checkpoint.save_step(d, step, {"x": torch.full((2,), float(step))},
                             keep=2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_00000003.npz", "ckpt_00000010.npz"]
    assert checkpoint.latest(d).endswith("ckpt_00000010.npz")
    assert checkpoint.latest(d) == jckpt.latest(d)
    got, meta = checkpoint.restore(checkpoint.latest(d),
                                   {"x": torch.zeros(2)})
    assert meta["step"] == 10 and got["x"].tolist() == [10.0, 10.0]


def test_unet_params_to_jax_inverts_interop_and_refuses_foreign_dicts():
    cfg = configs.TOY_UNET
    sd = interop.unet_params_from_jax(_jax_unet(5), cfg)
    assert _leaves_equal(interop.unet_params_to_jax(sd, cfg), _jax_unet(5))
    with pytest.raises(KeyError, match="conv_in.weight"):
        interop.unet_params_to_jax(
            {k: v for k, v in sd.items() if k != "conv_in.weight"}, cfg)
    with pytest.raises(ValueError, match="conv_in.weight"):
        interop.unet_params_to_jax(dict(sd, **{"conv_in.weight":
                                               torch.zeros(1)}), cfg)
