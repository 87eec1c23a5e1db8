"""Wrappers of the CUDA megakernel (``csrc/megastep_body.cuh``, built as
``csrc/megastep.cu`` for float32 weights, ``csrc/megastep_bf16.cu`` for
bfloat16 weights, ``csrc/megastep_f16.cu`` for float16 weights and
``csrc/megastep_mixed.cu`` for trees of several leaf types, each the
lockstep kernels with 'exact' attention, and their ``*_flash.cu``,
``*_rows.cu`` and ``*_flash_rows.cu`` twins: sixteen libraries).

Port of the two Pallas launchers in ``repro/kernels/megastep/kernel.py``:

  * ``megastep_call`` (B3): K consecutive plan steps, each the dense
    diffusion-LM eps trunk plus the Eq. 12 update, in one launch over the
    (R, 256) tile view (lockstep: one timestep per step).
  * ``megastep_rows_call`` (B4): one continuous-batching scheduler tick in
    one launch: the trunk with a timestep per slot, then the per-row
    update, every tile row with its own coefficient row.

Each wrapper checks its inputs, computes the small constant tables the TPU
kernel takes as hoisted constants (the sinusoidal time embeddings and the
RoPE cos / sin table) with the plain functions, asks the library for the
launch plan (one cooperative grid of one or two blocks per SM, the split-K
factors and the size of the one activation workspace of the whole batch),
allocates the output and that workspace with ``torch.empty``, launches on
PyTorch's current stream and counts the launch in its ``launches``
attribute; ``last_plan`` holds the plan of its latest launch, and a CUDA
int64 tensor set as its ``trace`` collects per-phase timestamps.  A
refused launch raises; nothing falls back.  On tensors that lie on the
CPU it runs the plain version (``ref.py``) and counts nothing; on a CUDA
tensor it launches or raises.

The kernel takes every input the TPU kernel computes: any seq_len,
latent, time_dim, d_model and d_ff (the product tiles zero-fill past any
edge), any even head dim (attention pads it to one of six widths up to
256, and past 256 streams it in chunks), GQA groups of whole heads, a
float32, bfloat16 or float16 state, and weights of those types: all of
one type (a library each: ``megastep``, ``megastep_bf16``,
``megastep_f16``) or of several (``megastep_mixed``).  The trunk computes
in JAX's promotion of the types: in a uniform tree a 16-bit trunk only
when state and weights are both of that type (float16 with bfloat16
promotes to float32); in a mixed tree each value at the type JAX's
promotion gives it (``trunk_types``, replayed on the leaf types: a
float32 norm scale over a bfloat16 row makes the normed row float32).
``kernel_limits`` states what stays refused, what JAX's own kernel
raises on: an odd head dim, n_heads not a multiple of n_kv_heads, a state
(or a leaf) of another type; ``ops.eligible`` applies it to states off
the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.diffusion_lm.model import EPS_PATH, param_shapes
from repro_torch.kernels import build
from repro_torch.kernels.sampler_step.ref import COEF_COLS, TILE_C
from repro_torch.models.common import rope_freqs, sinusoidal_time_embedding

from . import ref

ATTN_IMPLS = ("exact", "flash")
# state and weight types, by the code the library takes (0, 1, 2), and the
# library built for each weight type; MIXED names trees of several (code
# 3, the megastep_mixed library)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MIXED = "mixed"
_LIBRARY = {torch.float32: "megastep", torch.bfloat16: "megastep_bf16",
            torch.float16: "megastep_f16", MIXED: "megastep_mixed"}

# the order of the pointer fields of ReproMegaWeights in
# csrc/megastep_body.cuh
_POINTERS = (("w_in",), ("time_w1",), ("time_w2",), ("out_norm",),
             ("w_out",), ("layers", "attn_norm"), ("layers", "mlp_norm"),
             ("layers", "attn", "wq"), ("layers", "attn", "wk"),
             ("layers", "attn", "wv"), ("layers", "attn", "wo"),
             ("layers", "w_gate"), ("layers", "w_up"), ("layers", "w_down"))
# the fields of repro_megastep_plan's out[9], in order
_PLAN = ("workspace_floats", "grid", "blocks_per_sm", "barriers_per_step",
         "smem_bytes", "split_wo", "split_down", "split_out", "aligned")
_WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
           "time_dim", "latent", "head_dim")
# the rounding sites of a mixed tree (ReproMegaSite / ReproMegaLayerSite
# of csrc/megastep_body.cuh): the launch's, then a row for layer 0 and one
# for every later layer
_GLOBAL_SITES = ("t1", "t2", "in", "h0", "hl", "xo", "eps")
_LAYER_SITES = ("h", "xa", "q", "k", "v", "qk", "pv", "wo", "h1", "xm", "g",
                "u", "gu", "d", "h2")
_N_SITES = len(_GLOBAL_SITES) + 2 * len(_LAYER_SITES)


class _Weights(ctypes.Structure):
    """ReproMegaWeights: the weights' device pointers, the widths,
    ``dtype`` (the weights' type code, 3 for a mixed tree) and, read by the
    mixed library only, each pointer's type code, the rounding sites'
    codes and exact attention's sqrt(D) (layer 0, later layers)."""
    _fields_ = ([(p[-1], ctypes.c_void_p) for p in _POINTERS]
                + [(n, ctypes.c_int) for n in _WIDTHS]
                + [("norm_eps", ctypes.c_float), ("dtype", ctypes.c_int),
                   ("leaf", ctypes.c_int * len(_POINTERS)),
                   ("site", ctypes.c_int * _N_SITES),
                   ("attn_div", ctypes.c_float * 2)])


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.cache
def _lib(weight_dtype=torch.float32, flash: bool = False,
         rows: bool = False) -> ctypes.CDLL:
    """The library built for weights of ``weight_dtype`` (or MIXED), with
    'flash' attention or 'exact', of the scheduler tick (``rows``, B4) or
    the lockstep steps (B3)."""
    lib = build.load(_LIBRARY[weight_dtype] + ("_flash" if flash else "")
                     + ("_rows" if rows else ""))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_megastep_plan.argtypes = [ctypes.POINTER(_Weights), I, I, I, I,
                                        I, I, ctypes.POINTER(ctypes.c_longlong)]
    lib.repro_megastep_plan.restype = I
    lib.repro_megastep.argtypes = [P, P, ctypes.POINTER(_Weights), P, P, P,
                                   P, I, I, I, I, F, I, I, P, P, P]
    lib.repro_megastep.restype = I
    lib.repro_megastep_rows.argtypes = [P, P, ctypes.POINTER(_Weights), P,
                                        P, P, P, I, I, I, F, I, I, P, P, P]
    lib.repro_megastep_rows.restype = I
    return lib


def _shape_limits(cfg, state_dtype: torch.dtype) -> Optional[str]:
    """Why the CUDA megakernel cannot take this trunk or state (``widths_ok``
    of csrc/megastep_body.cuh, and the state's type), or None."""
    a = cfg.arch
    if a.n_heads % a.n_kv_heads:
        return (f"the CUDA megakernel takes n_heads a multiple of "
                f"n_kv_heads, got {a.n_heads} and {a.n_kv_heads}")
    D = a.hd()
    if D % 2 or D < 2:
        return (f"the CUDA megakernel takes an even head_dim (RoPE's "
                f"halves), got head_dim {D}")
    if state_dtype not in KERNEL_DTYPES:
        return (f"the CUDA megakernel takes a float32, bfloat16 or float16 "
                f"state, got dtype {state_dtype}")
    return None


def _weight_limits(params: Dict) -> Optional[str]:
    """Why the CUDA megakernel cannot read these weights (a leaf of none of
    float32, bfloat16 and float16), or None."""
    bad = sorted({str(t.dtype) for t in leaves(params)
                  if t.dtype not in KERNEL_DTYPES})
    if not bad:
        return None
    return (f"the CUDA megakernel takes weights of float32, bfloat16 or "
            f"float16, got dtype {', '.join(bad)}")


def weight_library(params: Dict):
    """The weight type whose library runs these eps-path weights: their
    one dtype, or MIXED for leaves of several."""
    dtypes = {t.dtype for t in leaves(params)}
    return dtypes.pop() if len(dtypes) == 1 else MIXED


def trunk_types(params: Dict, cfg, state_dtype: torch.dtype,
                attn_impl: str = "exact") -> Dict:
    """The type JAX's eps trunk gives each value, replaying its promotion
    (``jnp.matmul`` / elementwise ops of two types) on the leaf types:
    ``{"launch": {site: dtype}, "layers": [layer 0's, later layers'],
    "attn_div": [sqrt(D) as exact attention divides by it, per row]}``.
    A layer's types follow from the type of h entering it; a layer that
    makes h float32 leaves it so, so every layer past the first has the
    second row's types.  Exact attention divides q k^T by sqrt(D) computed
    in q's type; its probabilities are q's type and its output q's and v's
    promotion; 'flash' returns the attention in h's type."""
    P = torch.promote_types

    def t(*path):
        return _get(params, path).dtype

    a = cfg.arch
    t1 = P(state_dtype, t("time_w1"))
    t2 = P(t1, t("time_w2"))
    t_in = P(state_dtype, t("w_in"))

    def layer(h):
        xa = P(h, t("layers", "attn_norm"))
        q, k, v = (P(xa, t("layers", "attn", n)) for n in ("wq", "wk", "wv"))
        pv = P(q, v)
        wo = P(h if attn_impl == "flash" else pv, t("layers", "attn", "wo"))
        h1 = P(h, wo)
        xm = P(h1, t("layers", "mlp_norm"))
        g, u = P(xm, t("layers", "w_gate")), P(xm, t("layers", "w_up"))
        gu = P(g, u)
        d = P(gu, t("layers", "w_down"))
        return dict(h=h, xa=xa, q=q, k=k, v=v, qk=P(q, k), pv=pv, wo=wo,
                    h1=h1, xm=xm, g=g, u=u, gu=gu, d=d, h2=P(h1, d))

    h0 = P(t_in, t2)
    rows = [layer(h0)]
    rows.append(layer(rows[0]["h2"]))
    h = h0
    for i in range(a.n_layers):
        h = rows[min(i, 1)]["h2"]
    xo = P(h, t("out_norm"))
    D = a.hd()
    divs = [float(torch.tensor(float(D), dtype=r["q"]).sqrt().float())
            for r in rows]
    return {"launch": dict(t1=t1, t2=t2, **{"in": t_in}, h0=h0, hl=h, xo=xo,
                           eps=P(xo, t("w_out"))),
            "layers": rows, "attn_div": divs}


def kernel_limits(cfg, state_dtype: torch.dtype,
                  params: Dict) -> Tuple[bool, str]:
    """(ok, reason): does the CUDA megakernel take this trunk and state?

    It computes every input JAX's megakernel does, and refuses what JAX
    raises on: n_heads not a multiple of n_kv_heads, an odd head dim
    (``widths_ok`` of the source), a state of none of float32, bfloat16
    and float16, and (which JAX cannot hold) a leaf of another type.
    Every seq_len, width and head dim of the tile-aware trunk passes, and
    weights of one type or of several.  The plain version (``ref.py``)
    has none of these limits.  Needs no CUDA state: the weights may be
    meta tensors.  The launcher refuses the same inputs
    (``_check_kernel_inputs``)."""
    why = _shape_limits(cfg, state_dtype) or _weight_limits(params)
    return (False, why) if why else (True, "ok")


def _check_kernel_inputs(x2: torch.Tensor, params: Dict, cfg) -> None:
    pointed = {"/".join(p): _get(params, p) for p in _POINTERS}
    why = _shape_limits(cfg, x2.dtype) or _weight_limits(pointed)
    if why:
        raise ValueError(why)
    if not x2.is_contiguous():
        raise ValueError("the megakernel takes a contiguous state")
    shapes = param_shapes(cfg)
    for path in _POINTERS:
        t, want = _get(params, path), _get(shapes, path)
        name = "/".join(path)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x2.device:
            raise ValueError(f"{name} on {t.device}, state on {x2.device}")
    build.check_cuda(x2, *(_get(params, p) for p in _POINTERS))


def _code(dtype: torch.dtype) -> int:
    return KERNEL_DTYPES.index(dtype)


def _weights(params: Dict, cfg, dtype, state_dtype=torch.float32,
             attn_impl: str = "exact") -> _Weights:
    """ReproMegaWeights of the eps-path weights for the library of
    ``dtype`` (a weight type, or MIXED: then with the leaf codes, the
    sites of ``trunk_types`` for a state of ``state_dtype`` and the
    divisors)."""
    a = cfg.arch
    w = _Weights(*(_get(params, p).data_ptr() for p in _POINTERS),
                 a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.d_ff,
                 cfg.time_dim, cfg.latent_dim, a.hd(), a.norm_eps,
                 3 if dtype == MIXED else _code(dtype))
    if dtype == MIXED:
        ty = trunk_types(params, cfg, state_dtype, attn_impl)
        w.leaf[:] = [_code(_get(params, p).dtype) for p in _POINTERS]
        w.site[:] = ([_code(ty["launch"][n]) for n in _GLOBAL_SITES]
                     + [_code(r[n]) for r in ty["layers"]
                        for n in _LAYER_SITES])
        w.attn_div[:] = ty["attn_div"]
    return w


def _check_state(x2: torch.Tensor, params: Dict, cfg, batch: int,
                 seq_len: int, attn_impl: str) -> Dict:
    """The layout contract of both launchers; returns the eps-path
    weights."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    n = batch * seq_len * cfg.latent_dim
    if x2.dim() != 2 or x2.shape[1] != TILE_C or x2.numel() != n:
        raise ValueError(
            f"x2 {tuple(x2.shape)} is not a pure reshape of the ({batch}, "
            f"{seq_len}, {cfg.latent_dim}) state; the megakernel does not "
            f"compute on padding")
    return {k: params[k] for k in EPS_PATH}


def _trace_buffer(wrapper, steps: int, n_layers: int, dev):
    """The phase-stamp buffer of ``wrapper.trace`` (None when off): a
    CUDA int64 tensor of at least 2 + steps (2 + 5 n_layers) elements
    that the launch fills with %globaltimer stamps (ns) of block 0, one
    at the start and one after every phase and its grid barrier."""
    t = wrapper.trace
    if t is None:
        return None
    need = 2 + steps * (2 + 5 * n_layers)
    if (t.dtype != torch.int64 or t.device != dev or t.numel() < need
            or not t.is_contiguous()):
        raise ValueError(f"trace must be a contiguous int64 tensor of >= "
                         f"{need} elements on {dev}")
    return t


def _launch(wrapper, entry: str, x2: torch.Tensor, eps_params: Dict, cfg,
            batch: int, seq_len: int, ts: torch.Tensor,
            coefs: torch.Tensor, clip: Optional[float], attn_impl: str,
            *count) -> torch.Tensor:
    """Check the card-side contract, build the sinusoid / RoPE tables, ask
    for the launch plan, allocate the workspace and launch ``entry``;
    ``count`` are the leading int arguments that follow the coefficient
    pointer (K for B3).  Records the plan in ``wrapper.last_plan``.

    The tables are float32 holding what JAX's trunk multiplies by: the
    sinusoid cast to the state's type (``eps_forward``), and in a 16-bit
    trunk the RoPE cos / sin cast to its type (``apply_rope``; the mixed
    library rounds them to q's or k's type itself)."""
    _check_kernel_inputs(x2, eps_params, cfg)
    dev = x2.device
    w_dtype = weight_library(eps_params)
    trunk = (torch.float32 if w_dtype == MIXED
             else torch.promote_types(x2.dtype, w_dtype))
    temb = sinusoidal_time_embedding(ts.to(dev), cfg.time_dim).to(
        x2.dtype).float().contiguous()
    cos, sin = rope_freqs(torch.arange(seq_len, device=dev),
                          cfg.arch.hd(), cfg.arch.rope_theta)
    cos, sin = (z.to(trunk).float().contiguous() for z in (cos, sin))
    c32 = coefs.to(device=dev, dtype=torch.float32).contiguous()
    w = _weights(eps_params, cfg, w_dtype, x2.dtype, attn_impl)
    rows = entry == "repro_megastep_rows"
    flash = attn_impl == "flash"
    lib = _lib(w_dtype, flash, rows)
    plan = (ctypes.c_longlong * len(_PLAN))()
    with torch.cuda.device(dev):
        build.raise_on(lib.repro_megastep_plan(
            ctypes.byref(w), batch, seq_len, int(ts.shape[0]), rows,
            clip is not None, flash, plan), "repro_megastep_plan")
        ws = torch.empty(plan[0], dtype=torch.float32, device=dev)
        out = torch.empty_like(x2)
        build.check_cuda(temb, cos, sin, c32, ws, out)
        trace = _trace_buffer(wrapper, int(ts.shape[0]) if not rows else 1,
                              cfg.arch.n_layers, dev)
        err = getattr(lib, entry)(
            x2.data_ptr(), out.data_ptr(), ctypes.byref(w), temb.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), c32.data_ptr(), *count, batch,
            seq_len, clip is not None, 0.0 if clip is None else float(clip),
            flash, KERNEL_DTYPES.index(x2.dtype), ws.data_ptr(),
            None if trace is None else trace.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(err, entry)
    wrapper.last_plan = dict(zip(_PLAN, plan))
    return out


def megastep_call(x2: torch.Tensor, params: Dict, cfg, batch: int,
                  seq_len: int, coefs: torch.Tensor, ts: torch.Tensor, *,
                  clip: Optional[float] = None,
                  attn_impl: str = "exact") -> torch.Tensor:
    """One fused K-step launch over the (R, 256) tile view (B3).

    Args:
      x2: (R, 256) tile state that is a pure reshape of the (batch,
        seq_len, latent) natural state (no padding rows).
      params: the eps-path weights (``diffusion_lm.EPS_PATH`` keys).
      coefs: (K, 5) float32 rows [c_x0, c_dir, c_noise, sqrt_a_t,
        sqrt_1m_a_t] of the plan's table, on x2's device.
      ts: (K,) int timesteps of those rows, on x2's device.
      clip: |x0| bound or None (a compile-time specialization).
      attn_impl: 'exact' | 'flash' (a compile-time specialization).
    Returns the state after the K steps, (R, 256).
    """
    eps_params = _check_state(x2, params, cfg, batch, seq_len, attn_impl)
    K = int(ts.shape[0])
    if K < 1 or tuple(coefs.shape) != (K, 5):
        raise ValueError(f"coefs must be (K, 5) for K={K} timesteps, got "
                         f"{tuple(coefs.shape)}")
    if x2.device.type == "cpu":
        return ref.megastep_ref(x2, eps_params, cfg, batch, seq_len, coefs,
                                ts, clip=clip, attn_impl=attn_impl)
    out = _launch(megastep_call, "repro_megastep", x2, eps_params, cfg,
                  batch, seq_len, ts, coefs, clip, attn_impl, K)
    megastep_call.launches += 1
    return out


megastep_call.launches = 0
megastep_call.last_plan = None
megastep_call.trace = None


def megastep_rows_call(x2: torch.Tensor, params: Dict, cfg, batch: int,
                       seq_len: int, row_coefs: torch.Tensor,
                       slot_ts: torch.Tensor, *,
                       clip: Optional[float] = None,
                       attn_impl: str = "exact") -> torch.Tensor:
    """One fused scheduler tick over the (R, 256) slot-tile view (B4).

    Args:
      x2: (R, 256) slot-tile state, a pure reshape of the (batch, seq_len,
        latent) natural state (slot b owns rows [b R/batch, (b+1)
        R/batch)).
      params: the eps-path weights (``diffusion_lm.EPS_PATH`` keys).
      row_coefs: (R, 8) float32 per-row [c_x0, c_dir, c_noise, sqrt_a_t,
        sqrt_1m_a_t, pad...] (``sampler_step.ops.expand_slot_coefs``).
      slot_ts: (batch,) int timesteps, one per slot.
      clip, attn_impl: as for ``megastep_call``.
    Returns the state after the tick, (R, 256).
    """
    eps_params = _check_state(x2, params, cfg, batch, seq_len, attn_impl)
    R = x2.shape[0]
    if (tuple(row_coefs.shape) != (R, COEF_COLS)
            or row_coefs.dtype != torch.float32):
        raise ValueError(f"row_coefs must be ({R}, {COEF_COLS}) float32, "
                         f"got {tuple(row_coefs.shape)} {row_coefs.dtype}")
    if tuple(slot_ts.shape) != (batch,):
        raise ValueError(f"slot_ts must be ({batch},), got "
                         f"{tuple(slot_ts.shape)}")
    if x2.device.type == "cpu":
        return ref.megastep_rows_ref(x2, eps_params, cfg, batch, seq_len,
                                     row_coefs, slot_ts, clip=clip,
                                     attn_impl=attn_impl)
    out = _launch(megastep_rows_call, "repro_megastep_rows", x2,
                  eps_params, cfg, batch, seq_len, slot_ts, row_coefs, clip,
                  attn_impl)
    megastep_rows_call.launches += 1
    return out


megastep_rows_call.launches = 0
megastep_rows_call.last_plan = None
megastep_rows_call.trace = None
