"""Shared helpers of the example tests: import the JAX package's
``examples/`` (as ``benchmarks/_common.py`` does, by putting the folder
on ``sys.path``) and compare two printed runs line for line.

Comparison rule (``assert_same_lines``): after the run-time fields
(walls, latencies, s/step) are masked and JAX's backend name ``jnp`` is
read as the port's ``eager``, the lines match one for one; their text
outside numbers matches exactly (runs of spaces read as one), and each
number agrees with JAX's within 2 units of the last digit JAX printed
plus 1e-4 of its size.
"""
import re
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
TIMES = [re.compile(p) for p in (
    r"trained in [\d.]+s",
    r"trained (\d+) steps in [\d.]+s",
    r"\([\d.]+s/step\)",
    r"latency=[\d.]+ms",
)]


def jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    if str(EXAMPLES) not in sys.path:
        sys.path.append(str(EXAMPLES))
    import importlib
    return importlib.import_module(name)


def _mask(line: str, extra=()) -> str:
    for pat in list(TIMES) + list(extra):
        line = pat.sub("<t>", line)
    return " ".join(line.replace(" jnp", " eager").split())


def _decimals(tok: str) -> int:
    mant = tok.split("e")[0]
    return len(mant.split(".")[1]) if "." in mant else 0


def assert_same_lines(jax_out: str, port_out: str, extra_masks=()):
    jl = [_mask(x, extra_masks) for x in jax_out.strip().splitlines()]
    tl = [_mask(x, extra_masks) for x in port_out.strip().splitlines()]
    assert len(tl) == len(jl), (jl, tl)
    for j, t in zip(jl, tl):
        assert NUM.sub("#", t) == NUM.sub("#", j), (j, t)
        for a, b in zip(NUM.findall(t), NUM.findall(j)):
            tol = 2 * 10.0 ** -_decimals(b) + 1e-4 * abs(float(b))
            assert abs(float(a) - float(b)) <= tol, (j, t, a, b)
