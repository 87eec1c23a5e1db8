"""Roofline terms of the H100 (port of ``repro/launch/roofline.py``).

  compute term    = flops / (peak operations/s of the inputs' type)
  memory term     = traffic_bytes / HBM rate
  collective term = collective bytes / (NVLink rate * links per chip)

Every term is per device, as JAX's are: JAX reads per-device flops,
bytes and collective bytes from a partitioned module's HLO text
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
memory.  ``count`` sees one process's ops, so over a mesh its flops and
bytes are the whole step's; ``count_per_device`` gives one device's
share of them (flops split ideally; an argument's bytes at the block one
device holds, the rest split ideally), and ``launch/dryrun.py``
estimates the collective bytes from the sharding specs.
``pool_collective_bytes`` counts what a tick of a mesh-sharded slot pool
moves between mesh positions.

Hardware constants (NVIDIA H100 SXM data sheet, dense, at 700 W): HBM
3.35e12 B/s; float32 outside the tensor cores 67e12, TF32 495e12 and
bfloat16 989e12 operations/s; NVLink 4 at 450e9 B/s, one direction of
its 18 links (900 GB/s over both), in place of JAX's ``ICI_BW``.  A card
set below 700 W runs slower.  The NVLink rate is the data sheet's: a
one-card machine cannot measure it.  A mesh larger than one 8-card
NVLink domain crosses InfiniBand between hosts, which the term does not
model, as JAX's does not model DCN for its ``pod`` axis.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HBM_BW = 3.35e12              # bytes/s
PEAK_FLOPS_F32 = 67e12        # float32, CUDA cores (the port's float32)
PEAK_FLOPS_TF32 = 495e12      # TF32 tensor cores
PEAK_FLOPS_BF16 = 989e12      # bfloat16 / float16 tensor cores
NVLINK_BW = 450e9             # bytes/s, one direction of NVLink 4

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

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


def _op_operands(func, args, kwargs, out) -> List[Tuple[torch.Tensor, int]]:
    """(tensor, bytes) of every operand one aten op moves (see the module's
    docstring); an update that broadcasts is counted at its own size.  A
    gather's rows are read from its table, an in-place scatter's update is
    written into its destination."""
    name = func._schema.name.split("::")[-1]
    if name in _NO_TRAFFIC:
        return []
    if name in _GATHERS:
        outs = _distinct(_tensors(out))
        return ([(args[0], sum(map(_tensor_bytes, outs)))]
                + [(t, _tensor_bytes(t)) for t in outs]
                + [(t, _tensor_bytes(t))
                   for t in _distinct(_tensors((args[1:], kwargs)))])
    schema = func._schema.arguments
    if name in _SCATTERS:
        i = next(i for i, a in enumerate(schema)
                 if a.name == _SCATTERS[name])
        rest = _distinct(_tensors((args[1:], kwargs)))
        return ([(t, _tensor_bytes(t)) for t in rest]
                + [(args[0], _tensor_bytes(_arg(func, args, kwargs, i)))])
    overwritten = [t for i, a in enumerate(schema)
                   if a.alias_info is not None and a.alias_info.is_write
                   and (a.kwarg_only or name in _OVERWRITES)
                   for t in _tensors(_arg(func, args, kwargs, i))]
    reads = [t for t in _distinct(_tensors((args, kwargs)))
             if not any(t is w for w in overwritten)]
    return [(t, _tensor_bytes(t)) for t in reads + _distinct(_tensors(out))]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    """Adds up flops, bytes and ops; with ``held`` (storage -> the share
    of that tensor one device holds) also ``device_bytes``: a held
    tensor's bytes at its share, every other at ``1 / n_chips``."""

    def __init__(self, n_chips: int = 1, held: Optional[Dict] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.traffic_bytes = 0
        self.ops = 0
        self._split = Fraction(1, n_chips)
        self._held = held
        self.device_bytes = Fraction(0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        self.ops += 1
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        moved = _op_operands(func, args, kwargs, out)
        self.traffic_bytes += sum(b for _, b in moved)
        if self._held is not None:
            self.device_bytes += sum(
                b * self._held.get(_storage(t), self._split)
                for t, b in moved)
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


def count_per_device(fn: Callable, args: Sequence, n_chips: int,
                     held: Sequence[Tuple[torch.Tensor, int]]) -> Dict:
    """``count`` of ``fn(*args)`` over ``n_chips`` devices, plus
    ``device_bytes``: the bytes one device moves, exact (a ``Fraction``).
    ``held`` pairs each argument tensor with the bytes of its block on one
    device; an operand that is one of them, or a view of it, counts at
    that block's share of its bytes (a weight split only over "model"
    is read whole on each data replica).  Everything the step makes
    (activations, gradients, the new state) counts at ``1 / n_chips``,
    an ideal split: no partitioner runs, so where the step makes tensors
    that the devices would hold replicated (a train step's gradients and
    updated weights), the bytes are a lower bound."""
    shares = {}
    for t, b in held:
        if t.numel():
            if _storage(t) in shares:
                raise ValueError("two held tensors share one storage: their "
                                 "shares cannot be told apart")
            shares[_storage(t)] = Fraction(b, t.numel() * t.element_size())
    counter = _Counter(n_chips, shares)
    with counter, torch.no_grad():
        fn(*args)
    return {"flops": counter.flops, "traffic_bytes": counter.traffic_bytes,
            "ops": counter.ops, "device_bytes": counter.device_bytes}


def no_collectives() -> Dict[str, int]:
    """JAX's collective dict (``collective_bytes`` of its HLO parser): bytes
    per kind and the ``count`` of collectives, all 0."""
    return {**{k: 0 for k in COLLECTIVES}, "count": 0}


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device flops
    bytes_accessed: float        # per-device HBM bytes
    coll_bytes: float            # per-device collective bytes
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None    # 6*N*D (global, useful flops)
    useful_ratio: Optional[float] = None   # model_flops / global flops

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(counts: Dict, n_chips: int = 1,
            model_flops: Optional[float] = None,
            links_per_chip: float = 1.0, dtype=torch.float32,
            coll: Optional[Dict[str, int]] = None) -> RooflineTerms:
    """Roofline terms of per-device ``counts`` (``count``'s keys) with
    JAX's arithmetic and its ``max``-term bottleneck: ``coll`` is JAX's
    collective dict (bytes per kind of ``COLLECTIVES`` and a ``count``),
    none when omitted; ``collective_s = bytes / (NVLINK_BW *
    links_per_chip)``; ``useful_ratio = model_flops / (flops * n_chips)``.
    The compute peak is that of ``dtype``'s products (the port's float32
    runs without tensor cores)."""
    flops = float(counts["flops"])
    byts = float(counts["traffic_bytes"])
    breakdown = {k: int(v) for k, v in (coll or no_collectives()).items()}
    cbytes = float(sum(breakdown[k] for k in COLLECTIVES))
    compute_s = flops / peak_flops(dtype)
    memory_s = byts / HBM_BW
    collective_s = cbytes / (NVLINK_BW * links_per_chip)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / max(flops * n_chips, 1.0)
    return RooflineTerms(flops=flops, bytes_accessed=byts, coll_bytes=cbytes,
                         coll_breakdown=breakdown, compute_s=compute_s,
                         memory_s=memory_s, collective_s=collective_s,
                         bottleneck=bottleneck, model_flops=model_flops,
                         useful_ratio=useful)


def pool_collective_bytes(engine) -> Dict[str, int]:
    """Bytes that one tick of a scheduler engine on a mesh
    (``ContinuousBatchingEngine(mesh=)``) moves between mesh positions, in
    JAX's collective dict.  The engine decides how its tick runs eps
    (``eps_plan()``: per row block in place, or on the state gathered onto
    its device) and the eps model whether it splits its work over "model"
    (``serving/fleet/sharded.py``'s ``MeshEps.model_split``); the dtypes
    are the state's.  Counted from the mesh's block plan
    (``Mesh.data_model_grid``: data block i, model index j), never from
    device identity: a simulated mesh repeats one device, where a
    ``.to(device)`` moves nothing, yet each position stands for a card.
    Per tick, with k the slots of a data block:

      * the gathered plan only, where the state lies in several row blocks:
        the rows of blocks i >= 1 to the engine's device (the mesh's first
        position), "all-gather", and eps cut back into them,
        "collective-permute";
      * the gathered plan only, where the eps is a ``MeshEps``: its
        ``__call__`` cuts the batch into the data blocks of
        ``sharding.batch_spec`` (one block where they do not divide), x_i
        and t_i to block i's first position (i, 0) for i >= 1,
        "collective-permute", and joins eps_i back, "all-gather";
      * a ``MeshEps`` that splits over "model", on each data block: x_i
        and t_i sent from (i, 0) to each (i, j), j >= 1,
        "collective-permute", and the partials (k, n) sent back to (i, 0)
        and summed there, "all-reduce": JAX's ``psum``
        (``repro/serving/fleet/sharded.py``), which leaves the sum on every
        (i, j) where the port leaves it on (i, 0).

    JAX's ``shard_map`` emits none of the "collective-permute"s (its
    in_spec P(data, None) leaves x on every device of its data block) and
    gathers only where a consumer needs the whole batch.  "reduce-scatter"
    and "all-to-all" stay 0; ``count`` is the number of transfers.  The
    engine's per-slot tick inputs (t slices, B2's coefficient rows and
    seeds), sent to each block, are not counted."""
    out = no_collectives()
    if engine.mesh is None:
        return out
    plan = engine.eps_plan()
    blocks, eps = plan["block_bytes"], plan["eps"]
    x_item = plan["x_dtype"].itemsize
    t_item = plan["t_dtype"].itemsize
    row_b = math.prod(engine.shape) * x_item

    def move(kind, n_bytes, times):
        out[kind] += n_bytes * times
        out["count"] += times

    if plan["per_block"]:
        ks = [engine.slots // len(blocks)] * len(blocks)
    else:
        for state_b in blocks[1:]:
            move("all-gather", state_b, 1)
            move("collective-permute", state_b, 1)
        if not hasattr(eps, "apply_blocks"):
            return out
        from repro_torch.sharding import batch_spec
        n_data = eps.mesh.data_model_grid().shape[0]
        split = batch_spec(eps.mesh, engine.slots, 2)[0] is not None
        ks = ([engine.slots // n_data] * n_data if split
              else [engine.slots])
        for k in ks[1:]:
            move("collective-permute", k * row_b, 1)
            move("collective-permute", k * t_item, 1)
            move("all-gather", k * row_b, 1)
    if getattr(eps, "model_split", False):
        n_model = eps.mesh.data_model_grid().shape[1]
        for k in ks:
            move("collective-permute", k * row_b, n_model - 1)
            move("collective-permute", k * t_item, n_model - 1)
            move("all-reduce", k * row_b, n_model - 1)
    return out


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
