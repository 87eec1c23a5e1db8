"""Roofline terms of one H100 (port of ``repro/launch/roofline.py``, the
parts that mean something on one GPU).

  compute term = flops / (peak operations/s of the inputs' type)
  memory term  = traffic_bytes / HBM rate

JAX reads flops and bytes from a compiled module's HLO text
(``hlo_analysis.aggregate``).  The port has no compiled module: ``count``
runs the function once under a ``TorchDispatchMode`` and adds up what
every aten op does — flops by ``torch.utils.flop_counter``'s per-op
formulas (mm, addmm, bmm, baddbmm, convolution, SDPA), bytes as each op's
tensor inputs read once and outputs written once.  That is the op-by-op
traffic of eager PyTorch, the counterpart of ``aggregate``'s
``traffic_bytes``, with the bytes an op does not move left out as
``aggregate`` leaves them out:

  * views, ``_unsafe_view`` and allocations move none;
  * a gather (indexing, embedding, index_select, gather) reads the
    rows it returns, not its table: its output read and written, plus its
    indices (``aggregate`` counts a gather by its output);
  * an in-place scatter (``index_copy_``, ``index_put_``) writes its
    update, not the tensor it updates: the update read
    and written, plus its indices (``aggregate`` counts a
    dynamic-update-slice by its update operand);
  * a tensor an op overwrites without reading (``copy_``, ``fill_``,
    ``zero_``, an ``out=`` argument) is written once, not also read.

Copies that eager PyTorch does make (``clone`` of a permuted operand
before a product) are counted: the card moves those bytes.  It runs on
meta tensors, so a full-size combo is counted on any host without
memory.

The collective term is 0 here.  JAX's collective term
(``collective_bytes``, its HLO collective parser) and a mesh's terms are
not ported yet; they build on ``launch/mesh.py`` and ``sharding/``.

Hardware constants (NVIDIA H100 SXM data sheet, dense, at 700 W): HBM
3.35e12 B/s; float32 outside the tensor cores 67e12, TF32 495e12 and
bfloat16 989e12 operations/s.  A card set below 700 W runs slower.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HBM_BW = 3.35e12              # bytes/s
PEAK_FLOPS_F32 = 67e12        # float32, CUDA cores (the port's float32)
PEAK_FLOPS_TF32 = 495e12      # TF32 tensor cores
PEAK_FLOPS_BF16 = 989e12      # bfloat16 / float16 tensor cores

_PEAK_BY_DTYPE = {torch.float32: PEAK_FLOPS_F32,
                  torch.bfloat16: PEAK_FLOPS_BF16,
                  torch.float16: PEAK_FLOPS_BF16}


def peak_flops(dtype=torch.float32) -> float:
    """The card's peak operations/s for products in ``dtype``."""
    try:
        return _PEAK_BY_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"no H100 peak rate for {dtype}") from None


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans: its elements, or its strided footprint when
    that is smaller (an expanded, stride-0 operand is read once)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


def _is_view(func) -> bool:
    """True for an op whose result aliases an input without writing it
    (view, reshape alias, transpose, expand, slice, ...)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


# Ops that move no bytes: a view under another name, or an allocation.
_NO_TRAFFIC = frozenset({"_unsafe_view", "alias", "lift_fresh", "empty",
                         "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})
# Gathers: read the rows they return from their first operand.
_GATHERS = frozenset({"index", "embedding", "index_select", "gather"})
# In-place scatters, by the argument that holds their update.
_SCATTERS = {"index_copy_": "source", "index_put_": "values"}
# Ops that overwrite their mutated operand without reading it.
_OVERWRITES = frozenset({"copy_", "fill_", "zero_"})


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _distinct(ts) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _arg(func, args, kwargs, i):
    a = func._schema.arguments[i]
    return args[i] if i < len(args) else kwargs.get(a.name)


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves (see the module's docstring); an update that
    broadcasts is counted at its own size."""
    name = func._schema.name.split("::")[-1]
    if name in _NO_TRAFFIC:
        return 0
    if name in _GATHERS:
        return (2 * sum(map(_tensor_bytes, _distinct(_tensors(out))))
                + sum(map(_tensor_bytes,
                          _distinct(_tensors((args[1:], kwargs))))))
    schema = func._schema.arguments
    if name in _SCATTERS:
        i = next(i for i, a in enumerate(schema)
                 if a.name == _SCATTERS[name])
        rest = _distinct(_tensors((args[1:], kwargs)))
        return (sum(map(_tensor_bytes, rest))
                + _tensor_bytes(_arg(func, args, kwargs, i)))
    overwritten = [t for i, a in enumerate(schema)
                   if a.alias_info is not None and a.alias_info.is_write
                   and (a.kwarg_only or name in _OVERWRITES)
                   for t in _tensors(_arg(func, args, kwargs, i))]
    reads = [t for t in _distinct(_tensors((args, kwargs)))
             if not any(t is w for w in overwritten)]
    return (sum(map(_tensor_bytes, reads))
            + sum(map(_tensor_bytes, _distinct(_tensors(out)))))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.traffic_bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        self.ops += 1
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        self.traffic_bytes += _op_bytes(func, args, kwargs, out)
        return out


def count(fn: Callable, *args, **kw) -> Dict[str, int]:
    """Run ``fn(*args, **kw)`` once and count it: ``flops`` (products and
    convolutions, 2 per multiply-add), ``traffic_bytes`` (the bytes every
    aten op moves, as the module's docstring counts them) and ``ops``
    (aten ops that are not views).
    Works on meta tensors."""
    counter = _Counter()
    with counter, torch.no_grad():
        fn(*args, **kw)
    return {"flops": counter.flops, "traffic_bytes": counter.traffic_bytes,
            "ops": counter.ops}


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device flops
    bytes_accessed: float        # per-device HBM bytes
    coll_bytes: float            # per-device collective bytes (0: one card)
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None    # 6*N*D (global, useful flops)
    useful_ratio: Optional[float] = None   # model_flops / global flops

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(counts: Dict, model_flops: Optional[float] = None,
            dtype=torch.float32) -> RooflineTerms:
    """Roofline terms of ``count``'s result on one H100, with JAX's
    arithmetic (``n_chips=1``) and its ``max``-term bottleneck; the compute
    peak is that of ``dtype``'s products (the port's float32 runs without
    tensor cores).  A mesh's terms are not ported yet."""
    flops = float(counts["flops"])
    byts = float(counts["traffic_bytes"])
    compute_s = flops / peak_flops(dtype)
    memory_s = byts / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    bottleneck = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / max(flops, 1.0)
    return RooflineTerms(flops=flops, bytes_accessed=byts, coll_bytes=0.0,
                         coll_breakdown={"count": 0}, compute_s=compute_s,
                         memory_s=memory_s, collective_s=0.0,
                         bottleneck=bottleneck, model_flops=model_flops,
                         useful_ratio=useful)


def lm_model_flops(n_params_active: int, n_tokens: int,
                   kind: str = "train") -> float:
    """6*N*D for training; 2*N*D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


def memory_report(device=None) -> Dict:
    """Peak allocated / reserved bytes of a CUDA device since the last
    ``torch.cuda.reset_peak_memory_stats``; {} off CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"peak_allocated_bytes": int(st.get("allocated_bytes.all.peak", 0)),
            "peak_reserved_bytes": int(st.get("reserved_bytes.all.peak", 0))}
