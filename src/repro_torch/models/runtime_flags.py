"""Runtime performance flags (port of ``repro/models/runtime_flags.py``).

All default OFF so the baseline path is unchanged.  Flags are process-
global; ``perf_flags(**kw)`` sets some for the length of a ``with`` block
and restores the old values after it.  The model code reads them on each
call (the JAX package reads them at trace time).

Levers:
  * attn_chunk: KV-block size for chunked (online-softmax) attention in
    plain torch (``attention.chunked_grouped_attention``).  Bounds the score
    blocks at attn_chunk**2 instead of S**2 per head.
  * moe_group: routing group size of the MoE family (GShard's G axis,
    ``moe.MOE_GROUP``); smaller groups shrink the (G,S,E,C) dispatch
    one-hots at a slightly higher drop risk.
  * mesh, seq_parallel_spec, exp_in_spec, dispatch_spec: sharding hints
    (a ``launch.mesh.Mesh`` and partition specs, ``sharding.P``) for the
    residual stream between layers, the MoE expert input (E,G,C,d) and the
    routing one-hots.  ``constrain`` resolves a spec against ``mesh`` as
    the JAX package does and raises on an axis the mesh lacks; a sharding
    constraint never changes values, and eager PyTorch has no partitioner
    to hand it to, so the tensor comes back unchanged.  The JAX package's
    ``launch/dryrun.py`` sets them over ``make_production_mesh``; in the
    port only that dry run's counterpart is to set them.

Not needed: ``decode_inplace``.  In JAX it chose the carried-cache decode
over restacking each layer's cache; the port's decode always writes the
cache in place with the step's tables computed once, so
``dense.decode_step_inplace`` is ``dense.decode_step``.  Not a flag:
``accum_steps`` (``training/steps.py`` takes it as an argument).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class PerfFlags:
    seq_parallel_spec: Optional[Any] = None    # sharding.P or None
    attn_chunk: int = 0                        # 0 = full S^2 attention
    moe_group: int = 512
    exp_in_spec: Optional[Any] = None
    dispatch_spec: Optional[Any] = None        # (G,S,E,C) routing one-hots
    mesh: Optional[Any] = None                 # launch.mesh.Mesh


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


def constrain(x, spec):
    """Sharding constraint on ``x`` under ``FLAGS.mesh`` (the spec padded
    with None to x's rank; JAX then drops each entry whose dim the axis
    does not divide).  Returns ``x`` unchanged: a constraint never
    changes values.  Raises ValueError when the spec names an axis the
    mesh lacks.  A no-op without a spec or a mesh."""
    if spec is None or FLAGS.mesh is None:
        return x
    from repro_torch.sharding import NamedSharding, P
    NamedSharding(FLAGS.mesh,
                  P(*(tuple(spec) + (None,) * (x.dim() - len(spec)))))
    return x


def constrain_residual(x):
    """Apply the sequence-parallel constraint to a (B, S, d) carry."""
    return constrain(x, FLAGS.seq_parallel_spec)
