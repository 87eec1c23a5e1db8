"""Runtime performance flags (port of ``repro/models/runtime_flags.py``).

All default OFF so the baseline path is unchanged.  Flags are process-
global; ``perf_flags(**kw)`` sets some for the length of a ``with`` block
and restores the old values after it.  The model code reads them on each
call (the JAX package reads them at trace time).

The levers that mean something on one card:
  * attn_chunk: KV-block size for chunked (online-softmax) attention in
    plain torch (``attention.chunked_grouped_attention``).  Bounds the score
    blocks at attn_chunk**2 instead of S**2 per head.
  * moe_group: routing group size of the MoE family (GShard's G axis,
    ``moe.MOE_GROUP``); smaller groups shrink the (G,S,E,C) dispatch
    one-hots at a slightly higher drop risk.

Not needed: ``decode_inplace``.  In JAX it chose the carried-cache decode
over restacking each layer's cache; the port's decode always writes the
cache in place with the step's tables computed once, so
``dense.decode_step_inplace`` is ``dense.decode_step``.

Not ported: ``seq_parallel_spec``, ``exp_in_spec``, ``dispatch_spec``
and ``mesh`` (sharding hints; they wait for a second GPU and
``serving/fleet/sharded.py``) and ``accum_steps`` (``training/steps.py``
takes it as an argument).
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class PerfFlags:
    attn_chunk: int = 0                        # 0 = full S^2 attention
    moe_group: int = 512


FLAGS = PerfFlags()


@contextlib.contextmanager
def perf_flags(**kw):
    """Set flags for a block: ``with perf_flags(attn_chunk=64): ...``."""
    old = dataclasses.replace(FLAGS)
    for k, v in kw.items():
        if not hasattr(FLAGS, k):
            raise AttributeError(f"unknown or unported perf flag {k!r}")
        setattr(FLAGS, k, v)
    try:
        yield FLAGS
    finally:
        for f in dataclasses.fields(PerfFlags):
            setattr(FLAGS, f.name, getattr(old, f.name))
