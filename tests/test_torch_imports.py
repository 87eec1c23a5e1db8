"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("argv", [[], ["--launch-probe", "src"],
                                  ["--draw-probe", "src"], ["--p12-probe"],
                                  ["--p14-probe"]],
                         ids=["smoke", "launch-probe", "draw-probe",
                              "p12-probe", "p14-probe"])
def test_chip_smoke_refuses_without_a_card(argv, monkeypatch, capsys):
    """chip_smoke.py exits nonzero and prints no result line when torch
    sees no CUDA device, in either mode."""
    import importlib.util

    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
