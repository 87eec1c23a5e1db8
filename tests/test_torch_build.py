"""The kernel build (``repro_torch/kernels/build.py``) without nvcc: the
library name follows the source and every shared header, and every
``#include`` of a shared body resolves inside the package."""
import re

import pytest

from repro_torch.kernels import build

SOURCES = ["sampler_step", "rmsnorm", "flash_attention",
           "flash_attention_wide", "flash_attention_bf16",
           "flash_attention_bf16_wide", "flash_attention_f16",
           "flash_attention_f16_wide", "flash_attention_xl",
           "flash_attention_bf16_xl", "flash_attention_f16_xl",
           *(f"megastep{w}{a}{r}" for w in ("", "_bf16", "_f16", "_mixed")
             for a in ("", "_flash") for r in ("", "_rows")),
           "ddim_step"]


def _tree(tmp_path):
    (tmp_path / "a" / "csrc").mkdir(parents=True)
    (tmp_path / "b" / "csrc").mkdir(parents=True)
    src = tmp_path / "a" / "csrc" / "a.cu"
    src.write_text('#include "b/csrc/body.cuh"\n')
    hdr = tmp_path / "b" / "csrc" / "body.cuh"
    hdr.write_text("// body v1\n")
    other = tmp_path / "a" / "csrc" / "other.cuh"
    other.write_text("// other v1\n")
    return src, hdr, other


def test_a_header_edit_names_a_new_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    src, hdr, other = _tree(tmp_path)
    first = build.library_path(src, [hdr, other])
    assert first.parent == tmp_path / "out" and first.name.startswith("a-")
    assert build.library_path(src, [hdr, other]) == first
    hdr.write_text("// body v2\n")
    second = build.library_path(src, [hdr, other])
    assert second != first
    other.write_text("// other v2\n")
    assert build.library_path(src, [hdr, other]) not in (first, second)
    src.write_text('#include "b/csrc/body.cuh"\n// edited\n')
    assert build.library_path(src, [hdr, other]) not in (first, second)


def test_headers_are_hashed_for_every_source():
    names = {p.name for p in build.headers()}
    assert {"step_update.cuh", "rmsnorm_body.cuh", "online_softmax.cuh",
            "megastep_body.cuh", "mma_helpers.cuh",
            "flash_launch.cuh", "flash_xl.cuh"} <= names
    assert set(build.sources()) == set(SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_includes_resolve_under_the_include_dir(name):
    """nvcc gets ``-I kernels/``; every quoted include names a header of
    the package, so the hash covers what the build reads."""
    kernels = build.sources()[name].parents[2]
    assert ("-I", str(kernels)) == build.NVCC_FLAGS[-2:]
    text = build.sources()[name].read_text()
    incs = re.findall(r'#include "([^"]+)"', text)
    assert name in ("sampler_step", "ddim_step") or incs
    for inc in incs:
        assert (kernels / inc) in build.headers(), inc
