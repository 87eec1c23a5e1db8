"""Profiling hooks: tick ranges + the modeled-HBM attribution (port of
``repro/obs/profiling.py``).

* :func:`annotate`: a ``torch.profiler.record_function`` range, also an
  NVTX range when the process has a CUDA device.  Engines built with
  ``Observability(profile=True)`` wrap every tick in
  ``annotate("repro/tick/<variant>")`` (variant = mega | rows |
  multistep), so a ``torch.profiler`` capture groups the tick's device
  work under the same names as the JAX package's profiles.  An engine
  without ``profile`` never enters it.
* :func:`modeled_hbm_table`: the per-tick modeled device-memory traffic
  of a live engine, component by component, from its geometry.  The
  bytes are the JAX package's for the same geometry; only the notes
  differ (the ``mega`` trunk's weights sit in the card's 50 MB L2,
  ``MEGA_BUDGET``, where the TPU kernel holds them in VMEM).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from repro_torch.obs.schema import PROBE_COLUMNS


@contextlib.contextmanager
def annotate(name: str):
    """Context manager marking a host-side region in profiler traces."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def modeled_hbm_table(engine) -> List[Dict]:
    """Per-tick modeled device-memory rows for a ContinuousBatchingEngine.

    Returns ``[{"component", "bytes", "note"}, ..., {"component":
    "total", ...}]``; ``bytes`` is None for traffic the model cannot see
    (an opaque eps model's weight reads); the total sums the known rows.
    """
    R = engine.slots * engine._rps
    C = engine._tile_c
    item = _itemsize(engine.dtype)
    dtype = str(engine.dtype).replace("torch.", "")
    state = R * C * item
    B = engine.slots
    rows: List[Dict] = [
        {"component": "state_read", "bytes": state,
         "note": f"(R={R}, C={C}) slot tile in, {dtype}"},
        {"component": "state_write", "bytes": state,
         "note": "updated slot tile out"},
    ]
    n_coef = 6 + (1 if engine.stochastic else 0)
    coef = B * 4 * n_coef + (B * 4 * engine.max_order
                             if engine.max_order > 1 else 0)
    rows.append({"component": "coef_rows", "bytes": coef,
                 "note": f"per-slot step coefficients ({B} slots)"})
    if engine.tick_variant == "mega":
        spec = getattr(engine.eps_fn, "mega_spec", None)
        rows.append({"component": "trunk_weights",
                     "bytes": (spec.weight_bytes() if spec is not None
                               else None),
                     "note": "eps trunk read once per launch (held in the "
                             "50 MB L2 inside, MEGA_BUDGET)"})
        rows.append({"component": "eps_roundtrip", "bytes": 0,
                     "note": "fused in-kernel: eps never reaches device "
                             "memory"})
    else:
        rows.append({"component": "eps_roundtrip", "bytes": 2 * R * C * 4,
                     "note": "fp32 eps written by the model, read by the "
                             "step kernel"})
        rows.append({"component": "trunk_weights", "bytes": None,
                     "note": "opaque eps_fn: weight traffic not modeled"})
    if engine.max_order > 1:
        hbytes = (engine.max_order - 1) * R * C * 4
        rows.append({"component": "eps_history", "bytes": 2 * hbytes,
                     "note": f"(max_order-1={engine.max_order - 1}, R, C) "
                             "fp32 AB history read + write"})
    if engine.preview:
        rows.append({"component": "x0_preview", "bytes": R * C * item,
                     "note": "predicted-x0 second output"})
    if engine.probe_spec is not None:
        rows.append({"component": "probe_frame",
                     "bytes": B * len(PROBE_COLUMNS) * 4,
                     "note": f"({B}, {len(PROBE_COLUMNS)}) fp32 per-slot "
                             "probe reductions out (device->host once "
                             "per tick)"})
        if engine._probe_prev is not None:
            rows.append({"component": "probe_prev_eps",
                         "bytes": 2 * R * C * 4,
                         "note": "fp32 previous-eps carry for the defect "
                                 "proxy, read + write (order-1 engines "
                                 "only; multistep reuses the AB history "
                                 "row counted above)"})
    known = sum(r["bytes"] for r in rows if r["bytes"] is not None)
    unknown = sum(1 for r in rows if r["bytes"] is None)
    rows.append({"component": "total", "bytes": known,
                 "note": ("sum of modeled rows"
                          + (f" ({unknown} unmodeled row)" if unknown
                             else ""))})
    return rows


def format_hbm_table(rows: List[Dict]) -> str:
    """The attribution table as aligned text."""
    w = max(len(r["component"]) for r in rows)
    out = []
    for r in rows:
        b = "?" if r["bytes"] is None else f"{r['bytes']:,}"
        out.append(f"{r['component']:<{w}}  {b:>14}  {r['note']}")
    return "\n".join(out)
