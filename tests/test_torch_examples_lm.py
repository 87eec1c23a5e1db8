"""The port's ``lm_diffusion`` example against the JAX package's
(``examples/lm_diffusion.py``) on the CPU, below its default budget (2
train steps, batch 4, 2 sequences of 8 tokens, T = 50).

JAX's default family (dense) and the Mamba2 hybrid (whose chunked SSD
the port computes with its decays masked before exp) run in both
packages, and the printed run is JAX's, line for line, by the rule of
``tests/_torch_examples.py`` (text exact; every number within 2 units of
the last digit JAX printed plus 1e-4 of its size; the train wall and the
``wall_s`` column masked).  Bigram validity counts token pairs, so it
agrees only where every sampled token does.  The other two families (moe
and the rwkv6 ssm) run on the port alone here, and all three non-dense
families have their rows checked for form and finite values: their
trunks' ``training_loss`` and ``generate`` are held against JAX's in
``tests/test_torch_dlm.py``, and two more JAX runs would cost the suite
minutes of XLA compiles.
"""
import argparse
import math
import re

import pytest

from _torch_examples import assert_same_lines, jax_example
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch.examples import lm_diffusion

QUICK = dict(steps=2, batch=4, eval_batch=2, seq=8, vocab=64, T=50)
WALL = re.compile(r"(?<=\d) +[\d.]+$")          # the wall_s column
ROWS = [("DDPM", 50), ("DDIM", 50), ("DDIM", 20), ("DDIM", 10)]


def _argv(family):
    argv = ["--family", family, "--device", "cpu"]
    for k, v in QUICK.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


def test_lm_diffusion_prints_jaxs_lines(capsys):
    jax_example("lm_diffusion").main(
        argparse.Namespace(family="dense", **QUICK))
    jout = capsys.readouterr().out
    res = lm_diffusion.main(_argv("dense"))
    assert_same_lines(jout, capsys.readouterr().out, extra_masks=[WALL])
    assert [(r[0], r[1]) for r in res["rows"]] == ROWS


def test_lm_diffusion_hybrid_prints_jaxs_lines(capsys):
    jax_example("lm_diffusion").main(
        argparse.Namespace(family="hybrid", **QUICK))
    jout = capsys.readouterr().out
    lm_diffusion.main(_argv("hybrid"))
    assert_same_lines(jout, capsys.readouterr().out, extra_masks=[WALL])


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_lm_diffusion_other_families_run(family, capsys):
    res = lm_diffusion.main(_argv(family))
    out = capsys.readouterr().out
    assert "nan" not in out and "inf" not in out
    assert [(r[0], r[1]) for r in res["rows"]] == ROWS
    assert all(0.0 <= r[2] <= 1.0 for r in res["rows"])
    assert all(math.isfinite(x) for x in res["losses"])


def test_lm_diffusion_families_are_jaxs():
    assert lm_diffusion.FAMS == jax_example("lm_diffusion").FAMS
    args = lm_diffusion.parse_args([])
    assert (args.steps, args.batch, args.seq, args.T) == (800, 32, 32, 200)
