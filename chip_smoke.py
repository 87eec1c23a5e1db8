#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from anywhere inside a checkout:  python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (the kernels are built from the
sources in the checkout into build/repro_torch_kernels/).  Phases:

  1. card     name and power limit (nvidia-smi); TF32 off for cuDNN and
              matmul, so float32 convolutions are float32
  2. build    every CUDA source of the port, timed
  3. kernels  each kernel against its plain PyTorch version on the card,
              over det/stoch x clip x float32/bfloat16 x R in {16, 768 and
              the main path's 96 and 128} (+ want_x0 for the per-row
              kernel), with stated tolerances
  4. main     the sampling service at CIFAR10 width: DiffusionSampler
              (tile_resident=True) serves 16 requests (eta=0, S=20) and 8
              (eta=1, S=10), plan.run(backend='rows') runs one batch; the
              kernels' launch counters must grow by exactly S per batch;
              the outputs are checked against the eager path and the U-Net
              against its own CPU forward
  5. times    CUDA-graph-replayed kernel times at the main path's shapes and
              at R=768 beside their bytes bound and the plain versions'
              times; the U-Net forward at batch 8; samples/s from serve;
              a torch.profiler breakdown of one steady serve batch

Any failure raises and the script exits nonzero with no result line.  On
success the second-to-last line is the kernels' JSON record and the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
CARD_SHAPE = (32, 32, 3)
BATCH = 8
KERNEL_SOURCE = "src/repro_torch/kernels/sampler_step/csrc/sampler_step.cu"
TPU_KERNEL = "src/repro/kernels/sampler_step/kernel.py"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- timing
def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def loop_ms(fn, iters: int = 200) -> float:
    """Time of one call of ``fn`` issued from Python in a loop (CUDA
    events): what the step loop pays per launch, host overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_elems: int, elem_bytes: int, n_streams: int,
             extra_bytes: int, ops_per_elem: int):
    """Least time for the step: bytes over HBM rate vs ops over fp32 rate."""
    t_bytes = (n_elems * elem_bytes * n_streams + extra_bytes) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = n_elems * ops_per_elem / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations per element of the timed variants (no clip), counted from the
# body of csrc/sampler_step.cu.  An FMA counts 2, logf / sqrtf / cosf 1
# each; the PRNG's integer ops are counted at the float32 rate (the data
# sheet gives none for int32), which can only shorten the bound.  Index
# arithmetic and the per-launch coefficients and keys are not counted.
#   step:  b*eps, fma(a, x, .)                                       =  3
#   noise: 2 draws x 11 (xor, mul, add; fmix32: 3 shift, 3 xor, 2 mul)
#          + Box-Muller 13 (2 shift, 2 cvt, add, 5 mul, log, sqrt, cos)
#          + fma(c_noise, z, out) 2                                  = 37
OPS_STEP, OPS_NOISE = 3, 37


def main_rows():
    """Rows of the (R, 256) state the main path gives each kernel at batch
    BATCH: the tile layout (B1) and the slot layout (B2)."""
    from repro_torch.kernels.sampler_step import ops
    r_main = ops.to_tile_layout(
        torch.empty((BATCH,) + CARD_SHAPE, device="meta"))[0].shape[0]
    return r_main, BATCH * ops.slot_rows(CARD_SHAPE)


# ----------------------------------------------------------------- phases
def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} built/loaded in "
          f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")


def _tolerance(dtype, exact: bool, scale: float) -> float:
    if dtype == torch.bfloat16:
        return BF16_ULP * scale          # one bf16 ulp of max|out|
    return 0.0 if exact else 4 * F32_ULP * scale


def _report(errs, name, got, want, dtype, exact) -> None:
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = _tolerance(dtype, exact, scale)
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"[kernels] {name:<44} max|d|={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: max|d| {err} > tol {tol}")
    errs.append(err)


def phase_kernels():
    """B1 and B2 against their plain versions on the card."""
    from repro_torch.kernels.sampler_step import kernel, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    coefs = torch.tensor([0.9, 0.3, 1.0, 0.6, 0.8])   # c_noise = 1.0
    errs = {"sampler_step_2d": [], "sampler_step_rows_2d": []}
    # the 8-row granule, the main path's shapes (B1's and B2's), 256-row tiles
    for R in sorted({16, *main_rows(), 768}):
        x32 = torch.randn(R, 256, generator=gen, device=dev) * 2
        e32 = torch.randn(R, 256, generator=gen, device=dev)
        row_coefs = torch.rand(R, 8, generator=gen, device=dev) * 0.9 + 0.1
        row_coefs[:, 2] = 1.0
        row_seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (R,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            x, e = x32.to(dtype), e32.to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            for clip in (None, 1.0):
                for stoch in (False, True):
                    name = (f"R={R} {tag} clip={clip} "
                            f"{'stoch' if stoch else 'det'}")
                    exact = not stoch and clip is None
                    got = kernel.sampler_step_2d(
                        x, e, coefs, -98765, clip=clip, stochastic=stoch)
                    want = ref.sampler_step_2d(
                        x, e, coefs.to(dev), -98765, clip=clip,
                        stochastic=stoch)
                    _report(errs["sampler_step_2d"], "B1 " + name, got,
                            want, dtype, exact)
                    for want_x0 in (False, True):
                        kw = dict(clip=clip, stochastic=stoch,
                                  want_x0=want_x0)
                        got = kernel.sampler_step_rows_2d(
                            x, e, row_coefs, row_seeds, **kw)
                        want = ref.sampler_step_rows_2d(
                            x, e, row_coefs, row_seeds, **kw)
                        sub = f"B2 {name}{' x0' if want_x0 else ''}"
                        if want_x0:
                            _report(errs["sampler_step_rows_2d"],
                                    sub + " [x0]", got[1], want[1], dtype,
                                    exact=dtype == torch.float32)
                            got, want = got[0], want[0]
                        _report(errs["sampler_step_rows_2d"], sub, got,
                                want, dtype, exact and not want_x0)
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def _cifar10_model():
    """The CIFAR10-width U-Net, port's own init from a seed, with the
    near-zero leaves re-drawn at fan-in scale so that eps is O(1)."""
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.models.unet import ZERO_INIT_LEAVES, init_params
    gen = torch.Generator().manual_seed(0)
    model = init_params(CIFAR10_UNET, gen, device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(ZERO_INIT_LEAVES):
                w = torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), 0.0, 1.0, -3.0, 3.0,
                    generator=gen)
                p.copy_(w * p[0].numel() ** -0.5)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] CIFAR10_UNET: {n_params / 1e6:.2f} M parameters")
    return model.eval()


def phase_main(model):
    from repro_torch.core.schedules import make_schedule
    from repro_torch.kernels.sampler_step import kernel
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler
    dev = torch.device("cuda")
    eps_fn = make_eps_fn(model)
    schedule = make_schedule("linear", 1000)
    svc = DiffusionSampler(schedule, eps_fn, CARD_SHAPE, batch_size=BATCH,
                           tile_resident=True)
    det = SamplerPlan.build(schedule, 20)
    sto = SamplerPlan.build(schedule, 10, sigma=1.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    x_rows = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)

    # --- the main path, counted
    kernel.sampler_step_2d.launches = 0
    kernel.sampler_step_rows_2d.launches = 0
    out_det, st_det = svc.serve(16, det, seed=1)
    n1 = kernel.sampler_step_2d.launches
    out_sto, st_sto = svc.serve(8, sto, seed=2)
    n2 = kernel.sampler_step_2d.launches - n1
    out_rows = sto.run(eps_fn, x_rows, gen, backend="rows")
    torch.cuda.synchronize()
    launches = {"sampler_step_2d": kernel.sampler_step_2d.launches,
                "sampler_step_rows_2d": kernel.sampler_step_rows_2d.launches}
    print(f"[main] launches: {launches} (serve det {n1}, serve eta=1 {n2})")
    check(n1 == 2 * det.S, f"det serve launched B1 {n1} times, want "
          f"{2 * det.S}")
    check(n2 == sto.S, f"eta=1 serve launched B1 {n2} times, want {sto.S}")
    check(launches["sampler_step_rows_2d"] == sto.S,
          f"rows run launched B2 {launches['sampler_step_rows_2d']} times")
    for name, out, n in (("serve det", out_det, 16),
                         ("serve eta=1", out_sto, 8),
                         ("rows eta=1", out_rows, BATCH)):
        ok = out.shape == (n,) + CARD_SHAPE and bool(torch.isfinite(out)
                                                     .all())
        print(f"[main] {name}: shape {tuple(out.shape)} finite "
              f"{bool(torch.isfinite(out).all())} max|x| "
              f"{float(out.abs().max()):.4g}")
        check(ok, f"{name}: bad shape or non-finite output")
    print(f"[main] serve det stats: {st_det}")
    print(f"[main] serve eta=1 stats: {st_sto}")

    # --- correctness against the repo's own references
    x_T = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)
    a = det.run(eps_fn, x_T, backend="tile_resident")
    b = det.run(eps_fn, x_T, backend="eager")
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"[main] tile_resident vs eager, eta=0 S=20 batch {BATCH}: "
          f"max|d|/max|x| = {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, f"tile_resident vs eager: {rel} > 1e-3")
    t = torch.tensor([999], device=dev, dtype=torch.int32)
    with torch.no_grad():
        on_card = model(x_T[:1], t).cpu()
        on_cpu = copy.deepcopy(model).cpu()(x_T[:1].cpu(), t.cpu())
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"[main] U-Net forward card vs CPU, batch 1: max|d|/max|eps| = "
          f"{rel:.3e} (tol 1e-4), max|eps| = {float(on_cpu.abs().max()):.3g}")
    check(rel <= 1e-4, f"U-Net card vs CPU: {rel} > 1e-4")
    return launches, st_det, svc, det


def profile_batch(smi: str, svc, plan) -> None:
    """torch.profiler over one steady serve batch: device kernel time by
    kernel, and the device's idle share of the same batch's wall time
    measured without the profiler (its host cost slows the loop)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(3)
    _, wall_s = svc.sample_batch(plan, gen)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall_s = svc.sample_batch(plan, gen)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms == 0:
        print(f"[profile] {smi} | the profiler saw no device time: device "
              "busy/idle share not measured")
        return
    step_ms = sum(r[1] for r in rows if "step_kernel" in r[0]) / 1e3
    print(f"[profile] {smi} | one serve batch (eta=0, S={plan.S}, batch "
          f"{svc.batch}): wall {wall_s * 1e3:.1f} ms unprofiled "
          f"({prof_wall_s * 1e3:.1f} ms profiled), device kernels "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.3f}"
          f", sampler-step kernel {step_ms:.3f} ms, {len(rows)} kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile]   {us / 1e3:8.3f} ms  {count:5d}x  {key[:90]}")


def phase_times(smi: str, model, errs, launches, st_det):
    from repro_torch.kernels.sampler_step import kernel, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    coefs = torch.tensor([0.9, 0.3, 1.0, 0.6, 0.8])
    coefs_dev = coefs.to(dev)
    records = {}
    r_main, rows_main = main_rows()
    for kname, shapes in (("sampler_step_2d", (r_main, 768)),
                          ("sampler_step_rows_2d", (rows_main, 768))):
        for R in shapes:
            x = torch.randn(R, 256, generator=gen, device=dev)
            e = torch.randn(R, 256, generator=gen, device=dev)
            rc = torch.rand(R, 8, generator=gen, device=dev) + 0.1
            rs = torch.randint(0, 2 ** 31 - 1, (R,), generator=gen,
                               device=dev, dtype=torch.int32)
            for stoch in (False, True):
                if kname == "sampler_step_2d":
                    fn = lambda: kernel.sampler_step_2d(  # noqa: E731
                        x, e, coefs, 7, stochastic=stoch)
                    plain = lambda: ref.sampler_step_2d(  # noqa: E731
                        x, e, coefs_dev, 7, stochastic=stoch)
                    extra = 0
                else:
                    fn = lambda: kernel.sampler_step_rows_2d(  # noqa: E731
                        x, e, rc, rs, stochastic=stoch)
                    plain = lambda: ref.sampler_step_rows_2d(  # noqa: E731
                        x, e, rc, rs, stochastic=stoch)
                    extra = R * (8 * 4 + (4 if stoch else 0))
                n = R * 256
                ops_pe = OPS_STEP + (OPS_NOISE if stoch else 0)
                b_ms, b_by = bound_ms(n, 4, 3, extra, ops_pe)
                t = {"ms": graph_ms(fn), "plain_ms": graph_ms(plain),
                     "call_ms": loop_ms(fn), "bound_ms": b_ms,
                     "bound_by": b_by}
                variant = "stoch" if stoch else "det"
                print(f"[times] {smi} | {kname} R={R} f32 {variant}: "
                      f"kernel {t['ms'] * 1e3:.2f} us (graph), "
                      f"{t['call_ms'] * 1e3:.2f} us per Python call; "
                      f"plain {t['plain_ms'] * 1e3:.2f} us; bound "
                      f"{b_ms * 1e3:.3f} us ({b_by})")
                if R == shapes[0] and not stoch:
                    records[kname] = dict(t, R=R, variant="f32 det")
    x = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)
    t = torch.full((BATCH,), 500, device=dev, dtype=torch.int32)
    with torch.no_grad():
        unet_ms = loop_ms(lambda: model(x, t), iters=20)
    print(f"[times] {smi} | U-Net CIFAR10 forward batch {BATCH}: "
          f"{unet_ms:.3f} ms")
    print(f"[times] {smi} | serve eta=0 S=20 batch {BATCH}: steady "
          f"{st_det['steady_batch_s'] * 1e3:.1f} ms/batch, "
          f"{st_det['samples_per_s']:.2f} samples/s")
    kernels = []
    for kname, line in (("sampler_step_2d", 200),
                        ("sampler_step_rows_2d", 288)):
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:{line}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "call_ms": r["call_ms"], "R": r["R"],
            "variant": r["variant"]})
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    errs = phase_kernels()
    model = _cifar10_model()
    launches, st_det, svc, det = phase_main(model)
    kernels = phase_times(smi, model, errs, launches, st_det)
    profile_batch(smi, svc, det)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
