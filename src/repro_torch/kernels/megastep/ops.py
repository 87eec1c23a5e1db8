"""MegaSpec, the eligibility rule and the wrappers of the megakernels
(port of ``repro/kernels/megastep/ops.py``).

A ``MegaSpec`` is what a tile-aware eps model attaches to itself
(``diffusion_lm.make_tile_eps_fn`` sets ``eps_fn.mega_spec``) to declare
that its trunk can run inside the fused sampler step: the eps-path weights,
the static config and the (batch, seq_len) geometry they are bound for.

Eligibility (``eligible``; the plan-level half — deterministic, order 1 —
is the backend's): the model carries a spec, the state has the spec's
shape, a state off the CPU meets the CUDA kernel's own limits
(``kernel.kernel_limits``, which refuses only what JAX's kernel raises
on: an odd head dim, n_heads not a multiple of n_kv_heads, a state or
leaf of none of float32, bfloat16 and float16), and weights + activations
+ state fit ``MEGA_BUDGET`` under the JAX package's byte model
(``vmem_bytes``, unchanged: a weight or state counts its own type's
bytes, so a tree of mixed types counts each leaf at its size).  Anything
else runs the 'tile_resident' backend, or the scheduler's unfused tick.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import kernel as _k

MEGA_BUDGET = 39_321_600
"""Bytes that weights + activations + state may take, 0.75 x 50 MiB.

The TPU kernel keeps all of them in VMEM, and the JAX package admits a
trunk when they fit 12 MiB of a ~16 MiB VMEM (``MEGA_VMEM_BUDGET``, a 75%
share).  The H100 has no scratchpad that large: a block has at most 227 KB
of shared memory.  The smallest on-card memory that holds a smollm-width
trunk is the 50 MiB L2, where the megakernel's weights and its one
activation workspace for the whole batch (residual, q/k/v, attention and
MLP activations, split-K partials: 5.5 MB at batch 4 x 64 tokens) stay
between its phases; the port takes the same 75% share of it:
0.75 x 50 x 2**20 = 39,321,600 B.  At smollm-135m widths that admits the
2-layer float32 trunk at batch 4 x 64 tokens (35.5 MB exact, 36.1 MB
flash), 2 x 128 (36.1 MB either way) and 1 x 256 (37.3 MB exact, 36.1 MB
flash), and not batch 8 x 64 (41.6 / 42.8 MB), 1 x 320 exact (40.0 MB) or
the full 30 layers (432 MB).  bfloat16 (or float16) weights halve the
weight bytes: the 2-layer trunk then fits at 8 x 64 (26.9 MB exact, 28.1
MB flash, a 16-bit state) and a 4-layer one at 4 x 64 (34.9 / 35.5 MB),
not at 8 x 64 (41.1 / 42.3 MB); 6 layers do not fit at 4 x 64 (49.1
MB)."""

DEFAULT_K_FUSE = 8


@dataclasses.dataclass
class MegaSpec:
    """Everything the megakernel needs to run one eps trunk in-kernel.

    ``params`` holds ONLY the eps-path weights (w_in, time conditioning,
    stacked trunk layers, out head); the embedding and rounding tables
    never enter the sampler loop.
    """

    params: Dict[str, Any]        # eps-path weight dict (torch tensors)
    cfg: Any                      # DiffusionLMConfig
    batch: int
    seq_len: int
    attn_impl: str = "exact"      # 'exact' | 'flash' (see kernel.py)

    def __post_init__(self):
        if self.attn_impl not in _k.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {_k.ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")

    # ------------------------------------------------------------ memory
    def weight_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in _k.leaves(self.params)))

    def state_bytes(self, dtype=torch.float32) -> int:
        n = self.batch * self.seq_len * self.cfg.latent_dim
        return n * torch.empty((), dtype=dtype).element_size()

    def activation_bytes(self) -> int:
        """Peak live activation estimate for one trunk pass, float32: the
        residual stream and a handful of layer temporaries, plus the full
        score block ('exact') or one 128-wide KV block row ('flash')."""
        a = self.cfg.arch
        B, S = self.batch, self.seq_len
        live = B * S * (4 * a.d_model + 2 * a.d_ff)
        if self.attn_impl == "exact":
            live += B * a.n_heads * S * S
        else:
            live += B * a.n_heads * S * 128
        return int(live * 4)

    def vmem_bytes(self, dtype=torch.float32) -> int:
        """The budget number: weights + activations + state in/out."""
        return (self.weight_bytes() + self.activation_bytes()
                + 2 * self.state_bytes(dtype))

    # ------------------------------------------------------- eligibility
    def fits(self, budget: Optional[int] = None,
             dtype=torch.float32) -> bool:
        return self.vmem_bytes(dtype) <= (MEGA_BUDGET if budget is None
                                          else budget)


def eligible(spec: Optional[MegaSpec], x_T: torch.Tensor,
             budget: Optional[int] = None) -> Tuple[bool, str]:
    """(ok, reason): can this (eps model, state) pair run the megakernel?

    A state that is not on the CPU (a CUDA state, or a meta tensor that
    stands for one) must also meet the CUDA kernel's own limits
    (``kernel.kernel_limits``), which refuse only what JAX's kernel raises
    on: an odd head dim, n_heads not a multiple of n_kv_heads, a state of
    none of float32, bfloat16 and float16 (and a leaf of another type,
    which JAX cannot hold).  Every seq_len, width and head dim passes, and
    weights of one type or of several; so on every input JAX's kernel
    computes this gives JAX's answer.  The plain version the CPU runs has
    no limits."""
    if spec is None:
        return False, ("eps model carries no mega_spec (not a fused-capable "
                       "tile-aware trunk)")
    shape = (spec.batch, spec.seq_len, spec.cfg.latent_dim)
    if tuple(x_T.shape) != shape:
        return False, (f"state shape {tuple(x_T.shape)} != the spec's "
                       f"bound geometry {shape}")
    if x_T.device.type != "cpu":
        ok, why = _k.kernel_limits(spec.cfg, x_T.dtype, spec.params)
        if not ok:
            return False, why
    if not spec.fits(budget, x_T.dtype):
        return False, (f"weights+activations+state "
                       f"{spec.vmem_bytes(x_T.dtype)} B exceed the "
                       f"megakernel budget "
                       f"{MEGA_BUDGET if budget is None else budget} B")
    return True, "ok"


def megastep_tiles(x2: torch.Tensor, spec: MegaSpec, coefs: torch.Tensor,
                   ts: torch.Tensor, *, clip=None) -> torch.Tensor:
    """One fused K-step chunk over the (R, C) tile view (lockstep)."""
    return _k.megastep_call(x2, spec.params, spec.cfg, spec.batch,
                            spec.seq_len, coefs, ts, clip=clip,
                            attn_impl=spec.attn_impl)


def megastep_rows(x2: torch.Tensor, spec: MegaSpec, row_coefs: torch.Tensor,
                  slot_ts: torch.Tensor, *, clip=None) -> torch.Tensor:
    """One fused scheduler tick (per-slot t, per-row coefficients)."""
    return _k.megastep_rows_call(x2, spec.params, spec.cfg, spec.batch,
                                 spec.seq_len, row_coefs, slot_ts,
                                 clip=clip, attn_impl=spec.attn_impl)
