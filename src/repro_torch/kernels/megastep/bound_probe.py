"""What bounds the megakernel's product phases: the per-phase device time
of one B4 tick (``megastep_rows_call``, the phase trace of
``csrc/megastep.cu``) for the kernel as built and for two variants
compiled from the same source for this measurement only, whose outputs
are wrong on purpose:

  * ``no_mma``  without the tensor-core products of each depth slice
    (the copies, barriers and epilogues remain);
  * ``no_copy`` without the cp.async copies of each slice (the products
    run on whatever the ring holds).

A phase that keeps its time without the copies is bound by its products.

    python -m repro_torch.kernels.megastep.bound_probe

Needs one CUDA device and nvcc.  Runs at the slice's shape: the 2-layer
smollm-width trunk (``configs.DLM_SMOLLM_MEGA``), 4 slots x 64 tokens,
seeded random weights.
"""
from __future__ import annotations

import ctypes
import subprocess
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

from . import kernel

_SRC = build.sources()["megastep"]
# (text removed, text put in its place) per variant
_EDITS = {
    "no_mma": [("      mma_slice<NORM, DUAL>(st, t, t.sl0 + i, acc);\n", "")],
    "no_copy": [
        ("      if (i < n_sl) load_slice<DUAL>(smem + i * kStageFloats, t, "
         "t.sl0 + i);\n", ""),
        ("        load_slice<DUAL>(smem + (nx % kStages) * kStageFloats, t, "
         "t.sl0 + nx);\n", "        ;\n")],
}
PHASES = ("qkv", "attn", "wo", "mlp", "down")


def _variant_libs() -> Dict[str, ctypes.CDLL]:
    """Build the variants (in parallel) next to the kernels' libraries."""
    text = _SRC.read_text()
    procs = {}
    for name, edits in _EDITS.items():
        body = text
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old.strip()!r}")
            body = body.replace(old, new)
        src = build.BUILD_DIR / f"megastep_{name}.cu"
        lib = src.with_suffix(".so")
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(body)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    base = kernel._lib()
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               f"{proc.stderr.read()}")
        cdll = ctypes.CDLL(str(lib))
        for fn in ("repro_megastep_plan", "repro_megastep",
                   "repro_megastep_rows"):
            getattr(cdll, fn).argtypes = getattr(base, fn).argtypes
            getattr(cdll, fn).restype = getattr(base, fn).restype
        libs[name] = cdll
    return libs


def phase_times(tick, n_layers: int) -> List[Tuple[str, float]]:
    """(phase, us) of one launch of ``tick`` from the kernel's stamps."""
    wrapper = kernel.megastep_rows_call
    wrapper.trace = torch.zeros(2 + 2 + 5 * n_layers, dtype=torch.int64,
                                device="cuda")
    try:
        for _ in range(3):
            tick()
        torch.cuda.synchronize()
        st = wrapper.trace.tolist()
    finally:
        wrapper.trace = None
    names = (["time", "w_in"] + [f"L{i} {p}" for i in range(n_layers)
                                 for p in PHASES] + ["out"])
    return [(n, (b - a) / 1e3) for n, a, b in zip(names, st, st[1:])]


def main() -> None:
    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import init_params
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.sampling import SamplerPlan
    if not torch.cuda.is_available():
        raise RuntimeError("bound_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    batch, seq = 4, 64
    params = init_params(prng.PRNGKey(0, "cuda"), cfg)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    x2 = torch.randn(batch * seq * cfg.latent_dim // 256, 256,
                     generator=gen, device="cuda")
    tab = SamplerPlan.build(make_schedule("linear", 1000), 20).steps()
    cols = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")
    ks = [1, 7, 13, 19][:batch]
    ts = torch.tensor([int(tab["t"][k]) for k in ks], dtype=torch.int32,
                      device="cuda")
    coefs = torch.tensor([[float(tab[c][k]) for c in cols] for k in ks],
                         device="cuda")
    rows = sops.expand_slot_coefs(coefs, x2.shape[0] // batch)

    def tick():
        return kernel.megastep_rows_call(x2, params, cfg, batch, seq, rows,
                                         ts)
    runs = {"as built": None, **_variant_libs()}
    real = kernel._lib
    for name, lib in runs.items():
        if lib is not None:
            kernel._lib = lambda lib=lib: lib
        try:
            times = phase_times(tick, cfg.arch.n_layers)
        finally:
            kernel._lib = real
        total = sum(t for _, t in times)
        print(f"[bound] {smi} | B4 tick {cfg.arch.name} {batch} x {seq}, "
              f"{name}: {total:.1f} us; " + ", ".join(
                  f"{n} {t:.1f}" for n, t in times))


if __name__ == "__main__":
    main()
