"""What bounds the megakernel's product phases: the per-phase device time
of one B4 tick (``megastep_rows_call``, the phase trace of
``csrc/megastep_body.cuh``) for the kernel as built and for three
variants compiled from the same source for this measurement only, the
first two of whose outputs are wrong on purpose:

  * ``no_mma``  without the tensor-core products of each depth slice
    (the copies, barriers and epilogues remain);
  * ``no_copy`` without the copies of each slice (the products run on
    whatever the ring holds);
  * ``general`` with the general geometry's phases at this aligned one
    (right: what their edge checks, padded attention and separate time
    phase cost where no edge is met).

A phase that keeps its time without the copies is bound by its products.
Each run also prints the tick's bound (``bound_us``): its bytes over the
memory rate, and its operations (``operations``) over the peak rate of
the trunk's type and over the rate of the products as built (3xTF32
``mma.sync``: three TF32 passes in a float32 trunk, one in a bfloat16 or
float16 trunk, whose operands are exact in TF32).

    python -m repro_torch.kernels.megastep.bound_probe [--dtype bfloat16]

Needs one CUDA device and nvcc.  Runs at the slice's shape: the 2-layer
smollm-width trunk (``configs.DLM_SMOLLM_MEGA``), 4 slots x 64 tokens,
seeded random weights; ``--dtype bfloat16`` (or ``float16``) makes state
and weights bfloat16 (float16): the 16-bit trunk, the ``megastep_bf16``
(``megastep_f16``) library.
"""
from __future__ import annotations

import ctypes
import subprocess
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import roofline

from . import kernel

# (text removed, text put in its place) per variant
_EDITS = {
    "no_mma": [("      mma_slice<NORM, DUAL, G>(st, t, t.sl0 + i, bf16, inv0, "
                "inv1, acc);\n", "")],
    "no_copy": [
        ("      if (i < n_sl) load_slice<DUAL, G>(smem + i * kStageFloats, t, "
         "t.sl0 + i);\n", ""),
        ("        load_slice<DUAL, G>(smem + (nx % kStages) * kStageFloats, "
         "t,\n                            t.sl0 + nx);\n", "        ;\n")],
    "general": [("  p.general = kMixed || !aligned(*w, seq);\n",
                 "  p.general = 1;\n")],
}
PHASES = ("qkv", "attn", "wo", "mlp", "down")


def operations(cfg, batch: int, seq: int, K: int) -> int:
    """Operations of one K-step megastep launch, counted from the body of
    csrc/megastep_body.cuh: 2 per multiply-add of a product, 1 per other
    float operation (exp, divide, add, ...), index arithmetic and the
    bfloat16 roundings not counted."""
    a = cfg.arch
    d, T, L, F = a.d_model, cfg.time_dim, cfg.latent_dim, a.d_ff
    H, D = a.n_heads, a.hd()
    hq, hkv, S = H * D, a.n_kv_heads * D, seq
    per = 2 * T * T + 4 * T + 2 * T * d          # time MLP, silu
    per += 2 * S * L * d + S * d                 # w_in + temb
    lay = 2 * 4 * S * d                          # two RMSNorms
    lay += 2 * S * d * (hq + 2 * hkv)            # q, k, v
    lay += 3 * S * (hq + hkv)                    # RoPE: 6 per pair
    lay += H * (4 * S * S * D + 5 * S * S)       # q k^T, p v, softmax
    lay += 2 * S * hq * d + S * d                # wo, residual
    lay += 4 * S * d * F + 5 * S * F             # gate, up, silu * up
    lay += 2 * S * F * d + S * d                 # down, residual
    per += a.n_layers * lay + 4 * S * d + 2 * S * d * L + 3 * S * L
    return batch * K * per


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bound_us(cfg, batch: int, seq: int, K: int, state_dtype: torch.dtype,
             weight_dtype, rows: bool = False) -> Dict:
    """The least time of one launch (B3 with K steps, or with ``rows`` one
    B4 tick, K = 1) on the card, in µs: ``bytes`` (each eps-path weight
    read once at its type (``weight_dtype``: one type for every leaf, or
    the eps-path tree itself, whose leaves may differ; a tree's trunk is
    counted at the float32 rates), the state read and written once at its type,
    the coefficient, sinusoid and RoPE tables read once) over
    ``roofline.HBM_BW``; ``operations`` over the peak rate of the trunk's
    type (float32 CUDA cores, or 16-bit tensor cores when state and
    weights are both bfloat16 or both float16); ``operations_built`` over
    the rate of the products as built (TF32 tensor cores, three passes a
    float32 product, one a 16-bit one).  ``bound`` is the larger of bytes and
    operations, ``by`` which."""
    from repro_torch.diffusion_lm.model import EPS_PATH, param_shapes
    if isinstance(weight_dtype, dict):
        w_bytes = sum(t.numel() * t.element_size() for k in EPS_PATH
                      for t in kernel.leaves(weight_dtype[k]))
        weight_dtype = None
    else:
        shapes = param_shapes(cfg)
        w_bytes = sum(torch.Size(s).numel() for k in EPS_PATH
                      for s in kernel.leaves(shapes[k])) * _size(weight_dtype)
    n = batch * seq * cfg.latent_dim
    n_emb = batch if rows else K
    n_bytes = (w_bytes + 2 * n * _size(state_dtype)
               + (n // 256 * 8 if rows else K * 5) * 4
               + n_emb * (4 + cfg.time_dim * 4) + seq * cfg.arch.hd() * 4)
    ops = operations(cfg, batch, seq, K) + (3 * n if rows else 0)
    b16 = state_dtype == weight_dtype and state_dtype in (torch.bfloat16,
                                                          torch.float16)
    out = {"bytes": n_bytes / roofline.HBM_BW * 1e6,
           "operations": ops / (roofline.PEAK_FLOPS_BF16 if b16
                                else roofline.PEAK_FLOPS_F32) * 1e6,
           "operations_built": ops * (1 if b16 else 3)
           / roofline.PEAK_FLOPS_TF32 * 1e6,
           "n_bytes": n_bytes, "n_ops": ops}
    by = "bytes" if out["bytes"] >= out["operations"] else "operations"
    return {**out, "bound": out[by], "by": by}


def _variant_libs(weight_dtype: torch.dtype) -> Dict[str, ctypes.CDLL]:
    """Build the variants (in parallel) next to the kernels' libraries."""
    text = next(p for p in build.headers()
                if p.name == "megastep_body.cuh").read_text()
    weight = {torch.bfloat16: "__nv_bfloat16",
              torch.float16: "__half"}.get(weight_dtype, "float")
    procs = {}
    for name, edits in _EDITS.items():
        body = text
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old.strip()!r}")
            body = body.replace(old, new)
        src = build.BUILD_DIR / f"megastep_{name}_{weight}.cu"
        lib = src.with_suffix(".so")
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(f"#define REPRO_MEGA_WEIGHT {weight}\n"
                       f"#include <cuda_bf16.h>\n#include <cuda_fp16.h>\n"
                       f"{body}")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    base = kernel._lib(weight_dtype)
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


def main(argv=None) -> None:
    import argparse

    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import init_params
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.sampling import SamplerPlan
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "float16"),
                    default="float32",
                    help="the state's and the weights' type")
    dtype = getattr(torch, ap.parse_args(argv).dtype)
    if not torch.cuda.is_available():
        raise RuntimeError("bound_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    batch, seq = 4, 64
    params = init_params(prng.PRNGKey(0, "cuda"), cfg, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    x2 = torch.randn(batch * seq * cfg.latent_dim // 256, 256,
                     generator=gen, device="cuda").to(dtype)
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
    b = bound_us(cfg, batch, seq, 1, dtype, dtype, rows=True)
    print(f"[bound] {smi} | B4 tick {cfg.arch.name} {batch} x {seq}, "
          f"{dtype}: bound {b['bound']:.2f} us ({b['by']}); bytes "
          f"{b['bytes']:.2f} us, operations {b['operations']:.2f} us at the "
          f"type's peak, {b['operations_built']:.2f} us on the products as "
          f"built")
    runs = {"as built": None, **_variant_libs(dtype)}
    real = kernel._lib
    for name, lib in runs.items():
        if lib is not None:
            kernel._lib = lambda *a, lib=lib, **k: lib
        try:
            times = phase_times(tick, cfg.arch.n_layers)
        finally:
            kernel._lib = real
        total = sum(t for _, t in times)
        print(f"[bound] {smi} | B4 tick {cfg.arch.name} {batch} x {seq} "
              f"{dtype}, {name}: {total:.1f} us; " + ", ".join(
                  f"{n} {t:.1f}" for n, t in times))


if __name__ == "__main__":
    main()
