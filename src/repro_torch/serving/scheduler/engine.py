"""Continuous batching across diffusion timesteps (port of
``repro/serving/scheduler/engine.py``).

The engine keeps B resident SLOTS.  Each slot holds one request at its own
position of its own trajectory, described by its own frozen
``SamplerPlan`` (tau spacing, sigma schedule, solver order, noise seed).
One TICK advances every resident slot one step: the eps model on the slot
batch, then ONE launch of the per-row sampler-step kernel
``sampler_step_rows_2d`` (B2), in which every tile row reads its slot's
Eq. 12 coefficients and seed.  Finished slots retire and refill from the
EDF admission queue mid-flight; slot contents change tensor values only,
never the tick function (``compiled_ticks`` stays 1).

For an eligible engine the tick is instead one launch of the fused
scheduler-tick megakernel ``megastep_rows_call`` (B4): the dense
diffusion-LM trunk with a timestep per slot and the per-row update (the
JAX rule, ``_resolve_mega``).

State residency: the slot batch lives in the (B * rows_per_slot, 256)
slot-tile layout on the engine's device for a request's whole residency;
multistep engines also carry a (max_order-1, R, 256) float32 eps-history
stack.  Writes into a slot's rows (admission, restore) are in place.

Sharded pools (``mesh=``, a ``launch.mesh.Mesh``): the slot-tile state,
the eps-history stack and the probe buffer split their ROWS over the
mesh's data axes when the row count divides (JAX's rule; else they stay
whole on the mesh's first device), each block on its data block's first
device.  A tick evaluates eps per block where the eps model was built for
the same mesh (``serving/fleet/sharded.py``: ``.apply_blocks``) and the
blocks hold whole slots, else on the gathered state, and then launches
``sampler_step_rows_2d`` once PER BLOCK on that block's device.  B2's
noise is keyed on (row seed, lane), so a row's step does not depend on
the block it sits in; a block may start mid-slot.

x_T is ``prng.normal(PRNGKey(req.seed), dtype=<the engine's dtype>)``,
JAX's draw in that dtype (a bfloat16 engine's x_T is JAX's bfloat16
draw, not the float32 one rounded).

Differences from the JAX engine:
  * The tick ends in ``torch.cuda.synchronize`` where JAX blocks on the
    result, so the tick wall and its EWMA measure the same thing.  The
    per-tick slot states ship to the device in one host-to-device copy.
  * ``donate``, ``interpret`` and the TPU hardware PRNG are JAX-only and
    dropped.
  * On a mesh each state block must hold a multiple of B2's 8-row
    granule; a split that would not raises at construction.
  * JAX traces a tick program on its first call; here a tick function is
    built on its first call, and ``compiled_ticks`` counts those (one per
    variant run: the plain tick and, with ``probes=``, the probed one).
  * ``eps_params`` is a flat ``Dict[str, Tensor]`` (a module's state dict,
    applied with ``torch.func.functional_call``) or a nested dict/list of
    tensors, passed to ``eps_fn(params, x, t)`` on every tick.

Telemetry: counters, gauges and histograms in ``obs.registry``; span
events through the request's TraceContext; with ``probes=`` a second tick
function also returns a (slots, 6) float32 frame of per-slot numerics
(``obs/probes.py``), copied to the host once per probed tick and fed to
``SampleResult.quality``, the probe gauges and an optional
``FlightRecorder``; with ``obs.profile`` each tick runs inside an
``annotate("repro/tick/<variant>")`` range.

Deadline-aware admission: with a ``plan_bank`` (``repro_torch.autoplan``),
requests submitted with ``auto_plan=True`` get their plan from the bank
when the queue pops them (``_fill_auto_plan``), at this engine's measured
tick EWMA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.sampler import (StepStates, slot_row_inputs,
                                      slot_rows_update, slot_tile_eps)
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.solver import MAX_ORDER
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.sampler_step import ops as tile_ops
from repro_torch.kernels.sampler_step.ref import (GOLDEN, SUBLANE,
                                                  fmix32_u32)
from repro_torch.obs import Observability
from repro_torch.obs.probes import device_frame, normalize_probes
from repro_torch.obs.profiling import annotate
from repro_torch.obs.registry import SLACK_BUCKETS_S
from repro_torch.obs.schema import PROBE_COLUMNS
from repro_torch.obs.trace import plan_digest as _plan_digest
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.plan import _schedule_digest

from ..errors import RejectCode, RequestError
from .queue import AdmissionQueue
from .request import SampleRequest, SampleResult, SlotCheckpoint

_COEFS = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")
_I_EPS, _I_FIN, _I_DEF = (PROBE_COLUMNS.index(c)
                          for c in ("eps_rms", "finite_frac", "defect"))


def _flatten(tree, path=()):
    """[(path, leaf)] of a nested dict / list / tuple of tensors, dict keys
    in sorted order (the leaf order of a JAX pytree of dicts)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flatten(tree[k],
                                                          path + (k,))]
    if isinstance(tree, (list, tuple)):
        kind = type(tree).__name__
        return [e for i, v in enumerate(tree)
                for e in _flatten(v, path + (f"{kind}[{i}]",))]
    return [(path, tree)]


def _mesh_home(mesh, device: DeviceLike) -> torch.device:
    """A mesh engine's own device: the mesh's first device (data block 0,
    model index 0), which ``device``, when given, must name."""
    home = mesh.devices[mesh.data_model_grid()[0, 0]]
    if device is not None:
        d = torch.device(device)
        if d.type != home.type or (d.index is not None
                                   and home.index is not None
                                   and d.index != home.index):
            raise ValueError(f"device={d} but the mesh's first device is "
                             f"{home}")
    return resolve_device(home)


def _state_blocks(mesh, rows: int):
    """JAX's placement of the (rows, 256) slot state on a mesh: the rows
    split over the data axes when they divide, else whole.  Returns the
    ``NamedSharding`` and the row blocks [(lo, hi, device)], block i on
    data block i's first device."""
    from repro_torch.sharding import NamedSharding, P, data_axes
    grid = mesh.data_model_grid()
    dsize = grid.shape[0]
    split = dsize > 1 and rows % dsize == 0
    sharding = NamedSharding(mesh, P(data_axes(mesh) if split else None,
                                     None))
    n = dsize if split else 1
    blk = rows // n
    if blk % SUBLANE:
        raise ValueError(
            f"{rows} slot-tile rows over {n} data blocks gives {blk} rows a "
            f"block, not a multiple of the step kernel's {SUBLANE}-row "
            "granule: pick a slot count or data-axis size that keeps each "
            "block a multiple of it")
    return sharding, [(i * blk, (i + 1) * blk, mesh.devices[grid[i, 0]])
                      for i in range(n)]


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one resident request."""

    req: SampleRequest
    table: Dict[str, np.ndarray]   # per-step coefficient rows, sampling order
    k: int                         # next step index to run (0..S-1)
    admit_t: float
    previews: int = 0
    headroom_s: Optional[float] = None   # deadline - admit time (if any)
    # probe-quality accumulators (filled per probed tick, summarized into
    # SampleResult.quality at retirement; columns in obs/probes.py)
    q_frames: int = 0
    q_eps_rms: Optional[float] = None    # last tick's eps RMS
    q_finite_min: Optional[float] = None
    q_defect_max: Optional[float] = None
    q_defect_sum: float = 0.0
    q_defect_n: int = 0


class ContinuousBatchingEngine:
    """Slot-based continuous-batching server for DDIM-family sampling.

    One engine has one tick function for its (slots, sample_shape, dtype,
    stochastic, clip_x0, preview, max_order) configuration, plus one probed
    tick with ``probes=``; admission, retirement, per-request plan mixes
    and weight installs never rebuild them.

    Args:
      schedule: the noise schedule the eps model was trained with; plan
        requests must be built on it (checked by digest at submit).
      eps_fn: eps_theta(x_t, t), t an int32 (B,) tensor (every slot at its
        own timestep).  Models may set ``slot_tile_aware = True`` to take
        the (R, 256) slot-tile view directly.
      sample_shape: per-request sample shape.
      slots: number of resident requests B advanced per tick.
      dtype: state dtype (float32, bfloat16 or float16).
      stochastic: build the in-kernel-noise tick; a deterministic engine
        serves noise-free plans only and its tick has no PRNG code.
      clip_x0: engine-level |x0| clip (a kernel specialization); plan
        requests must carry the matching X0Policy.
      preview: build the x0-preview tick (B2's second output, streamed
        through ``on_preview`` every ``preview_every`` ticks).
      max_order: highest Adams–Bashforth order the tick supports (1..4).
      eps_params: model weights passed INTO the tick on every call
        (``eps_fn(params, x, t)``): a flat ``Dict[str, Tensor]`` (a
        module's state dict through ``torch.func.functional_call``) or a
        nested dict/list of tensors.  None keeps ``eps_fn(x, t)`` with its
        own weights.  With params the weights are hot-swappable:
        ``install_eps_params`` replaces them between ticks, same keys,
        shapes, dtypes and devices, without building a new tick.  Such an
        engine never takes the mega tick.
      max_queue: admission-queue depth bound (None = unbounded).
      use_mega: the fused scheduler tick (B4).  None decides by the JAX
        rule (deterministic, order 1, preview-free, and the eps model's
        ``mega_spec`` eligible for (slots, *sample_shape)); True raises
        with the reason when it does not hold; False forces the unfused
        tick.
      plan_bank: a ``repro_torch.autoplan.PlanBank`` searched on this
        engine's noise schedule (digest-validated).  Requests submitted
        with ``auto_plan=True`` get their SamplerPlan chosen AT ADMISSION:
        the largest-NFE bank row that fits the request's deadline headroom
        at the measured EWMA tick latency (one tick advances a resident
        request one step); deadline-free requests are served the quality
        end of the frontier.  Rows incompatible with this engine
        (stochastic rows on a deterministic engine, order > max_order,
        clip mismatch) are never selected.
      select_margin: safety factor on the deadline fit — a bank row fits
        when NFE * tick_ewma_s <= headroom * select_margin.
      tick_ewma_alpha: smoothing factor for the per-tick latency EWMA
        that feeds the selection policy (``stats()['tick_ewma_s']``);
        0.0 freezes a seeded ``tick_ewma_s`` (virtual-clock replays).
        The first tick (kernel builds, library set-up) is never folded in.
      pool_id: identity stamped on stats and results.
      obs: an ``obs.Observability``; None builds a private, sink-less one.
        Its registry holds the engine's counters, gauges and histograms
        (``stats()`` is a view over them); a trace sink turns on span
        events; ``profile=True`` runs each tick inside an
        ``annotate("repro/tick/<variant>")`` range.
      probes: None (default) builds nothing extra; True or a frozen
        ``ProbeSpec`` builds a second tick function that also reduces the
        raw eps and the pre/post-step state into a (slots, 6) float32
        frame per tick (eps RMS, x0 range, finite fraction, the one-eval
        step-doubling defect proxy).  The plain tick is untouched, so
        probes-off stays bitwise a probe-less engine, and ``set_probes``
        switches between the two (at most 2 tick functions).  Refused
        with the mega tick.
      flight: an optional ``obs.FlightRecorder`` fed every probe frame
        and the slot -> request map.
      device: where the engine runs; None is the CUDA card (on a mesh:
        the mesh's first device, which ``device`` must name if given).
      mesh: a ``("data", "model")`` (or ``("pod", "data", "model")``)
        ``launch.mesh.Mesh`` this pool's tick runs on; None = single
        device.  The slot-tile state rows split over the data axes when
        divisible; the eps model is expected to carry mesh-placed weights
        (``serving/fleet/sharded.py``).  ``stats()`` reports the mesh
        shape and whether the state is split.
    """

    def __init__(self, schedule: NoiseSchedule, eps_fn: Callable,
                 sample_shape: Tuple[int, ...], slots: int,
                 dtype: torch.dtype = torch.float32, *,
                 stochastic: bool = False,
                 clip_x0: Optional[float] = None, preview: bool = False,
                 max_order: int = 1,
                 eps_params=None,
                 max_queue: Optional[int] = None,
                 use_mega: Optional[bool] = None,
                 plan_bank=None, select_margin: float = 0.9,
                 tick_ewma_alpha: float = 0.2,
                 mesh=None, pool_id: Optional[int] = None,
                 obs: Optional[Observability] = None,
                 probes=None, flight=None,
                 device: DeviceLike = None):
        if not 1 <= max_order <= MAX_ORDER:
            raise ValueError(f"max_order must be in 1..{MAX_ORDER}, got "
                             f"{max_order}")
        self.schedule = schedule
        self.eps_fn = eps_fn
        self.shape = tuple(sample_shape)
        self.slots = int(slots)
        self.dtype = dtype
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else _mesh_home(mesh, device))
        self.stochastic = stochastic
        self.clip_x0 = clip_x0
        self.preview = preview
        self.max_order = int(max_order)
        self.plan_bank = plan_bank
        self.select_margin = float(select_margin)
        self.tick_ewma_alpha = float(tick_ewma_alpha)
        self.tick_ewma_s: Optional[float] = None
        if plan_bank is not None and (_schedule_digest(plan_bank.schedule)
                                      != _schedule_digest(schedule)):
            raise ValueError(
                "plan_bank was searched on a different noise schedule "
                "than this engine serves — re-search or load the "
                "matching bank")
        self._last_outcome: Optional[str] = None
        self.pool_id = pool_id
        self.eps_params = eps_params
        self.use_mega = self._resolve_mega(use_mega)
        self.tick_variant = ("mega" if self.use_mega else
                             "multistep" if self.max_order > 1 else "rows")
        self.probe_spec = normalize_probes(probes)
        if self.probe_spec is not None and self.use_mega:
            raise ValueError(
                "probes are unavailable on the mega tick variant: the eps "
                "evaluation never leaves the fused megastep kernel, so the "
                "device probes have nothing to reduce — build the engine "
                "with use_mega=False to probe it")
        self.probes_on = self.probe_spec is not None
        self.flight = flight
        self.last_frame: Optional[Dict] = None
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._c_ticks = reg.counter("engine_ticks_total",
                                    "engine ticks executed",
                                    variant=self.tick_variant)
        self._c_slot_steps = reg.counter(
            "engine_slot_steps_total", "active slot-steps advanced")
        self._c_completed = reg.counter(
            "engine_completed_total", "requests retired with a sample")
        self._c_dropped = reg.counter(
            "engine_dropped_total",
            "requests dropped (expiry or back-pressure)")
        self._c_previews = reg.counter(
            "engine_previews_total", "x0 previews delivered")
        self._c_bank_selected = reg.counter(
            "engine_bank_selected_total",
            "auto_plan requests served a bank row")
        self._c_compiled = reg.counter(
            "engine_compiled_ticks_total",
            "tick functions built (one per variant run: at most 2)")
        self._c_miss = reg.counter(
            "engine_deadline_miss_total",
            "requests finished or dropped past their deadline")
        self._c_cancelled = reg.counter(
            "engine_cancelled_total",
            "requests cancelled by the client (slot or queue freed)")
        self._c_resumed = reg.counter(
            "engine_resumed_total",
            "checkpointed trajectories resumed mid-flight")
        self._c_installs = reg.counter(
            "engine_weight_installs_total",
            "eps_params hot-swaps installed (no new tick function)")
        self._c_wall = reg.counter(
            "engine_tick_wall_seconds",
            "accumulated wall time inside the tick")
        self._g_active = reg.gauge(
            "engine_active_slots", "resident requests after the last tick")
        self._c_frames = reg.counter(
            "engine_probe_frames_total",
            "device probe frames transferred to the host")
        self._g_defect = reg.gauge(
            "engine_probe_defect_max",
            "max per-slot step-doubling defect proxy, last probed tick")
        self._g_finite = reg.gauge(
            "engine_probe_finite_frac_min",
            "min per-slot finite fraction, last probed tick")
        self._last_defect_max: Optional[float] = None
        self._last_finite_min: Optional[float] = None
        self._g_ewma = reg.gauge(
            "engine_tick_ewma_seconds",
            "EWMA per-tick latency (first tick of each variant excluded)")
        self._h_tick = reg.histogram(
            "engine_tick_seconds",
            "per-tick wall latency (first tick of each variant excluded)")
        self._h_wait = reg.histogram(
            "engine_queue_wait_seconds", "submit -> admit queue wait")
        self._h_service = reg.histogram(
            "engine_service_seconds", "admit -> retire service time")
        self._h_latency = reg.histogram(
            "engine_request_latency_seconds",
            "submit -> retire end-to-end latency")
        self._h_slack = reg.histogram(
            "engine_deadline_slack_seconds",
            "deadline - finish at retirement (negative = missed)",
            edges=SLACK_BUCKETS_S)
        self._n = int(np.prod(self.shape))
        self._rps = tile_ops.slot_rows(self.shape)
        self._tile_c = tile_ops.TILE_C
        rows = self.slots * self._rps
        self._state_sharding = None
        # row blocks of the state, [(lo, hi, device)]; one whole block off
        # a mesh.  The state, the eps history and the probe buffer are
        # lists of these blocks.
        self._blocks = [(0, rows, self.device)]
        if mesh is not None:
            self._state_sharding, self._blocks = _state_blocks(
                mesh, rows)
        # one state block per data block, each holding whole slots: a
        # mesh eps can run on the blocks in place
        self._whole_slot_blocks = (
            mesh is not None
            and len(self._blocks) == mesh.data_model_grid().shape[0]
            and self.slots % len(self._blocks) == 0)
        # every device a tick may queue work on (the tick wall waits for
        # all of them)
        self._devices = ([self.device] if mesh is None else
                         list(dict.fromkeys(mesh.devices.ravel())))
        self._x2 = self._alloc((rows, self._tile_c), dtype)
        self._hist2 = (self._alloc((self.max_order - 1, rows, self._tile_c),
                                   torch.float32, dim=1)
                       if self.max_order > 1 else None)
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._free: List[int] = list(range(self.slots))[::-1]
        self.queue = AdmissionQueue(max_queue, obs=self.obs)
        self._tables: Dict[SamplerPlan, Dict[str, np.ndarray]] = {}
        self._schedule_digest = None   # filled lazily from the first plan
        self._traces = 0
        # inactive-slot filler row: an EXACT identity update on the no-clip
        # path (a = c_x0/sqrt_a = 1, b = c_dir - a*sqrt_1m_a = 0 => x' = x);
        # the clip path divides by sqrt_1m_a, so there it is 1.0 and idle
        # slots hold clip(x - eps), finite.  Idle rows are never read back.
        self._idle_row = dict(t=1, c_x0=1.0, c_dir=0.0, c_noise=0.0,
                              sqrt_a_t=1.0,
                              sqrt_1m_a_t=1.0 if clip_x0 is not None
                              else 0.0)
        # probe-only previous-eps buffer for the defect proxy on order-1
        # engines (multistep engines read the pre-update newest history
        # row; see obs/probes.py on the one-eval proxy)
        self._probe_prev = (
            self._alloc((rows, self._tile_c), torch.float32)
            if (self.probe_spec is not None and self.probe_spec.defect
                and self.max_order == 1) else None)
        self._tick_fns: Dict[bool, Callable] = {}   # probed? -> tick

    # ----------------------------------- registry-backed counters (views)
    @property
    def ticks(self) -> int:
        return int(self._c_ticks.value)

    @property
    def slot_steps(self) -> int:
        return int(self._c_slot_steps.value)

    @property
    def completed(self) -> int:
        return int(self._c_completed.value)

    @property
    def dropped(self) -> int:
        return int(self._c_dropped.value)

    @property
    def previews_sent(self) -> int:
        return int(self._c_previews.value)

    @property
    def bank_selected(self) -> int:
        return int(self._c_bank_selected.value)

    @property
    def deadline_missed(self) -> int:
        return int(self._c_miss.value)

    @property
    def weight_installs(self) -> int:
        return int(self._c_installs.value)

    @property
    def _tick_wall_s(self) -> float:
        return float(self._c_wall.value)

    # ------------------------------------------------------ tick functions
    def _resolve_mega(self, use_mega: Optional[bool]) -> bool:
        """Fused-tick eligibility: ``megastep.eligible`` (the rule shared
        with ``plan.run(backend='mega')``) on this engine's (slots,
        *sample_shape) state, plus the engine's half: deterministic,
        history-free and preview-free."""
        if use_mega is False:
            return False
        from repro_torch.kernels import megastep as mega_ops

        spec = getattr(self.eps_fn, "mega_spec", None)
        if self.eps_params is not None:
            ok, why = False, ("megakernel tick bakes its trunk weights "
                              "into the fused kernel's spec; a hot-swappable "
                              "eps_params engine runs the unfused tick")
        elif self.stochastic or self.preview or self.max_order > 1:
            ok, why = False, ("megakernel tick is deterministic/order-1/"
                              "preview-free only")
        else:
            state = torch.empty((self.slots,) + self.shape,
                                dtype=self.dtype, device=self.device)
            ok, why = mega_ops.eligible(spec, state)
        if ok:
            return True
        if use_mega:                       # explicitly requested: loud
            raise ValueError(f"use_mega=True but {why}")
        return False

    def _bind_eps(self, params):
        """The eps callable a tick sees: ``eps_fn`` itself, or on an
        eps_params engine ``eps_fn`` with ``params`` bound, keeping the
        ``slot_tile_aware`` marker the slot-tile step dispatches on."""
        if params is None:
            return self.eps_fn
        raw = self.eps_fn

        def bound(x, t):
            return raw(params, x, t)

        bound.slot_tile_aware = getattr(raw, "slot_tile_aware", False)
        return bound

    def _eps_on_blocks(self, eps_fn) -> bool:
        """The tick's eps plan: True where eps runs per row block in place
        (``apply_blocks`` of an eps built for this mesh, every block
        holding whole slots), False where it runs on the state gathered
        onto the engine's device."""
        return (self._whole_slot_blocks
                and getattr(eps_fn, "mesh", None) == self.mesh
                and hasattr(eps_fn, "apply_blocks")
                and not getattr(eps_fn, "slot_tile_aware", False))

    def eps_plan(self) -> Dict:
        """What a tick hands its eps, for counting what it moves
        (``launch.roofline.pool_collective_bytes``): ``per_block`` (the
        tick's plan above; False on the mega tick, which runs no eps
        model), the eps model, the bytes of each of the state's row
        blocks, and the dtypes of the state and of the t column."""
        eps = self._bind_eps(self.eps_params)
        return {"per_block": not self.use_mega and self._eps_on_blocks(eps),
                "eps": None if self.use_mega else eps,
                "block_bytes": [x.numel() * x.element_size()
                                for x in self._x2],
                "x_dtype": self._x2[0].dtype,
                "t_dtype": self._states().t.dtype}

    def install_eps_params(self, new_params) -> None:
        """Hot-swap the model weights without building a new tick.

        Only on an engine built with ``eps_params=``.  The replacement
        must match the resident weights in structure (keys) and in every
        leaf's shape, dtype and device.  The fleet tier swaps only on an
        idle pool; see ``SlotPool.install``.
        """
        if self.eps_params is None:
            raise RuntimeError(
                "engine has no eps_params to swap: closure-captured "
                "weights are compiled into the tick — build the engine "
                "with eps_params= to make weights installable")
        old, new = _flatten(self.eps_params), _flatten(new_params)
        old_p, new_p = [p for p, _ in old], [p for p, _ in new]
        if old_p != new_p:
            raise ValueError(
                "install_eps_params: new pytree structure differs from "
                f"the resident weights (only in new: "
                f"{sorted(set(new_p) - set(old_p))[:5]}, only in resident: "
                f"{sorted(set(old_p) - set(new_p))[:5]})")
        def desc(t):
            return f"{tuple(t.shape)}/{str(t.dtype).removeprefix('torch.')}"
        for i, ((_, o), (_, n)) in enumerate(zip(old, new)):
            if o.shape != n.shape or o.dtype != n.dtype:
                raise ValueError(
                    f"install_eps_params: leaf {i} is {desc(n)}, resident "
                    f"is {desc(o)} — a swap must preserve shapes/dtypes "
                    "to reuse the compiled tick")
            if o.device != n.device:
                raise ValueError(
                    f"install_eps_params: leaf {i} is on {n.device}, "
                    f"resident is on {o.device}")
        self.eps_params = new_params
        self._c_installs.inc()

    def _tick(self, probed: bool) -> Callable:
        """The tick function of one variant, built (and counted in
        ``compiled_ticks``) the first time it runs."""
        fn = self._tick_fns.get(probed)
        if fn is None:
            fn = self._tick_fns[probed] = self._make_tick(probed)
            self._traces += 1
            self._c_compiled.inc()
        return fn

    def _make_tick(self, probed: bool):
        """The tick over the state's row blocks (one block off a mesh).

        Plain tick: (x2, hist2, states, params) -> (x2, x0 preview or
        None, hist2).  Probed tick: (x2, hist2, prev, states, params) ->
        (x2, x0, hist2, frame, prev), the same step returning the raw eps
        as well, plus the (slots, 6) probe frame; ``prev`` is the order-1
        defect buffer.  Each state is a list of row blocks.  eps runs per
        block where the eps model has ``apply_blocks`` for this mesh and
        every block holds whole slots, else on the state gathered onto the
        engine's device and cut back into blocks; then one
        ``slot_rows_update`` (one B2 launch) per block on its device.  The
        mega tick runs on the gathered state."""
        shape, clip, rps, n = self.shape, self.clip_x0, self._rps, self._n
        blocks, rows = self._blocks, self.slots * self._rps
        nb = len(blocks)

        def gather(arr, dim=0):
            return None if arr is None else self._read_rows(arr, 0, rows,
                                                            dim)

        def scatter(x, dim=0):
            return [x.narrow(dim, lo, hi - lo).to(dev)
                    for lo, hi, dev in blocks]

        if self.use_mega:
            from repro_torch.kernels import megastep as mega_ops
            spec = self.eps_fn.mega_spec

            def tick(x2b, hist2b, states, params):
                row_coefs = tile_ops.expand_slot_coefs(
                    states.coef_matrix(), rps)
                return (scatter(mega_ops.megastep_rows(
                    gather(x2b), spec, row_coefs, states.t, clip=clip)),
                    None, hist2b)
            return tick

        def eps_blocks(eps_fn, x2b, t):
            if self._eps_on_blocks(eps_fn):
                k = self.slots // nb
                xs = [tile_ops.from_slot_tile_layout(xb, n, (k,) + shape)
                      for xb in x2b]
                ts = [t[i * k:(i + 1) * k].to(dev)
                      for i, (_, _, dev) in enumerate(blocks)]
                return [tile_ops.to_slot_tile_layout(e)[0]
                        for e in eps_fn.apply_blocks(xs, ts)]
            return scatter(slot_tile_eps(eps_fn, gather(x2b), t, shape))

        def step(x2b, hist2b, states, params, want_eps):
            with torch.no_grad():
                eps_b = eps_blocks(self._bind_eps(params), x2b, states.t)
                row_coefs, row_seeds, row_w = slot_row_inputs(
                    states, rps, self.stochastic)
                outs, x0s, hists = [], [], []
                for i, (lo, hi, dev) in enumerate(blocks):
                    out, new_h = slot_rows_update(
                        x2b[i], eps_b[i], row_coefs[lo:hi].to(dev),
                        None if row_seeds is None
                        else row_seeds[lo:hi].to(dev),
                        hist2=None if hist2b is None else hist2b[i],
                        row_w=None if row_w is None
                        else row_w[:, lo:hi].to(dev),
                        clip_x0=clip, stochastic=self.stochastic,
                        want_x0=self.preview)
                    if self.preview:
                        out, x0 = out
                        x0s.append(x0)
                    outs.append(out)
                    hists.append(new_h)
            return (outs, x0s if self.preview else None,
                    hists if hist2b is not None else None,
                    eps_b if want_eps else None)

        if not probed:
            def tick(x2b, hist2b, states, params):
                return step(x2b, hist2b, states, params, False)[:3]
            return tick

        spec = self.probe_spec

        def tick(x2b, hist2b, prevb, states, params):
            # hist2 is the PRE-update stack: row 0 is the previous tick's
            # raw eval, the defect proxy's reference on multistep engines
            eps_prev = (gather(prevb) if hist2b is None
                        else gather(hist2b, 1)[0] if spec.defect else None)
            x_new, x0, new_hist2, eps_b = step(x2b, hist2b, states, params,
                                               True)
            frame = device_frame(spec, gather(x2b), gather(x_new),
                                 gather(eps_b), eps_prev, states, rps=rps,
                                 n_live=n)
            if prevb is not None:
                prevb = [e.to(torch.float32) for e in eps_b]
            return x_new, x0, new_hist2, frame, prevb
        return tick

    # --------------------------------------------------- state row blocks
    def _alloc(self, shape, dtype: torch.dtype, dim: int = 0):
        """A zero state of ``shape`` whose rows lie on ``dim``, as a list
        of row blocks on their devices."""
        out = []
        for lo, hi, dev in self._blocks:
            s = list(shape)
            s[dim] = hi - lo
            out.append(torch.zeros(s, dtype=dtype, device=dev))
        return out

    def _read_rows(self, arr, lo: int, hi: int, dim: int = 0):
        """Rows [lo, hi) of a row-block list, gathered onto the engine's
        device from the blocks that hold them (a view with one block)."""
        parts = [blk.narrow(dim, max(lo, a) - a, min(hi, b) - max(lo, a))
                 .to(self.device)
                 for (a, b, _), blk in zip(self._blocks, arr)
                 if a < hi and lo < b]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def _write_rows(self, arr, lo: int, hi: int, rows: torch.Tensor,
                    dim: int = 0) -> None:
        """Overwrite rows [lo, hi) of a row-block list in place."""
        for (a, b, _), blk in zip(self._blocks, arr):
            s, e = max(lo, a), min(hi, b)
            if s < e:
                blk.narrow(dim, s - a, e - s).copy_(
                    rows.narrow(dim, s - lo, e - s))

    def set_probes(self, on: bool) -> None:
        """Pick which tick function runs: the probed or the plain one.

        Only on an engine built with ``probes=``: the probed tick is built
        for the construction-time ProbeSpec, so enabling probes on a
        spec-less engine raises.
        """
        if on and self.probe_spec is None:
            raise RuntimeError(
                "engine was built without probes= — the probed tick is a "
                "construction-time compiled variant, not a runtime add-on")
        self.probes_on = bool(on)

    # ------------------------------------------------------------ plumbing
    def _table_for(self, req: SampleRequest) -> Dict[str, np.ndarray]:
        plan = req.resolved_plan(self.schedule, self.clip_x0)
        if plan not in self._tables:
            self._tables[plan] = plan.steps()
        return self._tables[plan]

    def _validate_plan(self, req: SampleRequest) -> None:
        plan = req.plan
        if plan is None:
            return
        if self._schedule_digest is None:
            self._schedule_digest = _schedule_digest(self.schedule)
        if plan.schedule_digest() != self._schedule_digest:
            raise RequestError(
                RejectCode.SCHEDULE_MISMATCH,
                f"request {req.request_id}: plan built on a different "
                "noise schedule than this engine serves")
        if plan.x0.clip != self.clip_x0:
            raise RequestError(
                RejectCode.CLIP_MISMATCH,
                f"request {req.request_id}: plan clip_x0={plan.x0.clip} != "
                f"engine clip_x0={self.clip_x0} (the clip is a kernel "
                "specialization of the slot pool)")
        if plan.order > self.max_order:
            raise RequestError(
                RejectCode.ORDER_UNSUPPORTED,
                f"request {req.request_id}: plan order={plan.order} exceeds "
                f"engine max_order={self.max_order} (build the engine with "
                "max_order >= the largest solver order it must serve)")

    def validate_request(self, req: SampleRequest) -> None:
        """Raise if this engine can never serve ``req``: a typed
        ``RequestError`` (a ValueError) whose ``.code`` is a RejectCode."""
        if req.auto_plan:
            if req.plan is not None:
                raise RequestError(
                    RejectCode.AUTO_PLAN_CONFLICT,
                    f"request {req.request_id}: auto_plan=True and an "
                    "explicit plan are mutually exclusive (the engine "
                    "fills plan in at admission)")
            if self.plan_bank is None:
                raise RequestError(
                    RejectCode.NO_PLAN_BANK,
                    f"request {req.request_id}: auto_plan=True needs an "
                    "engine built with plan_bank=")
            if self._bank_candidates() == 0:
                raise RequestError(
                    RejectCode.BANK_INCOMPATIBLE,
                    f"request {req.request_id}: the plan bank has no entry "
                    "compatible with this engine (stochastic rows need a "
                    f"stochastic engine; order <= max_order="
                    f"{self.max_order}; clip == {self.clip_x0})")
            return
        if req.stochastic and not self.stochastic:
            raise RequestError(
                RejectCode.STOCHASTIC_UNSUPPORTED,
                f"request {req.request_id}: a stochastic plan (sigma > "
                "0 somewhere) needs a stochastic=True engine "
                "(the deterministic tick has no PRNG)")
        self._validate_plan(req)
        if not 1 <= req.steps <= self.schedule.T:
            raise RequestError(
                RejectCode.BAD_STEPS,
                f"request {req.request_id}: S={req.steps} "
                f"outside [1, T={self.schedule.T}]")

    def submit(self, req: SampleRequest,
               now: Optional[float] = None) -> bool:
        """Enqueue a request; False means rejected (queue back-pressure)."""
        self.validate_request(req)
        now = time.perf_counter() if now is None else now
        self.obs.trace_submit(req, now, deadline=req.deadline)
        return self.queue.submit(req, now)

    # ------------------------------------------------- deadline-aware bank
    def _bank_candidates(self) -> int:
        """How many bank rows this engine could actually serve."""
        return len(self.plan_bank.compatible(
            deterministic=None if self.stochastic else True,
            max_order=self.max_order, clip=self.clip_x0))

    def _select_plan(self, req: SampleRequest, now: float):
        """The admission-time bank pick (the deadline-aware policy).

        headroom = deadline - now (infinite without a deadline); the
        per-step latency estimate is the EWMA tick time — a resident
        request advances exactly one step per tick, so a plan fits when
        NFE * tick_ewma_s <= headroom * select_margin.  Before the first
        measured tick the policy is conservative (smallest row) for
        deadline requests and quality-greedy for deadline-free ones.
        """
        headroom = (math.inf if req.deadline is None
                    else max(req.deadline - now, 0.0))
        return self.plan_bank.select(
            headroom, self.tick_ewma_s, margin=self.select_margin,
            deterministic=None if self.stochastic else True,
            max_order=self.max_order, clip=self.clip_x0,
            on_outcome=self._bank_outcome)

    def _bank_outcome(self, outcome: str, plan) -> None:
        """PlanBank.select telemetry hook: count WHY each row was picked
        (quality / conservative / fit / degraded / none) and WHAT it was
        (per-NFE counter)."""
        self._last_outcome = outcome
        reg = self.obs.registry
        reg.counter("engine_bank_outcome_total",
                    "auto_plan selections by policy outcome",
                    outcome=outcome).inc()
        if plan is not None:
            reg.counter("engine_bank_nfe_total",
                        "auto_plan selections by chosen NFE",
                        nfe=plan.S).inc()

    def _fill_auto_plan(self, req: SampleRequest, now: float) -> None:
        """The queue's pop-time ``select`` hook: fill an auto_plan
        request's plan from the bank using THIS engine's tick EWMA."""
        if req.auto_plan and req.plan is None:
            req.plan = self._select_plan(req, now)
            self._c_bank_selected.inc()
            ctx = req.trace
            if ctx is not None and req.plan is not None:
                ctx.nfe = req.plan.S
                ctx.plan_digest = _plan_digest(req.plan)
                ctx.emit("select", now, outcome=self._last_outcome)

    @property
    def active(self) -> int:
        return self.slots - len(self._free)

    @property
    def capacity(self) -> int:
        """Free slots not already spoken for by the local queue."""
        return max(len(self._free) - len(self.queue), 0)

    def pending_steps(self) -> int:
        """Remaining step budget, resident + queued.  Queued ``auto_plan``
        requests count their S field — an estimate; the real NFE is picked
        at admission."""
        rem = sum(s.req.steps - s.k for s in self._slots if s is not None)
        rem += sum(r.steps for r in self.queue.pending_requests())
        return rem

    def _drop(self, req: SampleRequest, now: float, missed: bool = True,
              reason: Optional[str] = None) -> SampleResult:
        """Account one never-ran request (``reason`` emits the span's
        terminal ``drop`` event; back-pressure drops pass None)."""
        self._c_dropped.inc()
        if missed:
            self._c_miss.inc()
        if reason is not None and req.trace is not None:
            req.trace.emit("drop", now, reason=reason)
        return SampleResult.drop(req, now, missed=missed,
                                 pool_id=self.pool_id)

    def _draw_xT(self, seed: int) -> torch.Tensor:
        """x_T of one slot, (rows_per_slot, 256): JAX's normal from
        ``PRNGKey(seed)`` on the engine's device."""
        key = prng.PRNGKey(int(seed), self.device)
        x = prng.normal(key, (1,) + self.shape, dtype=self.dtype)
        return tile_ops.to_slot_tile_layout(x)[0]

    def _admit(self, now: float, results: List[SampleResult]) -> None:
        while self._free and len(self.queue):
            req, missed = self.queue.pop(now, select=self._fill_auto_plan)
            results.extend(self._drop(m, now, reason="expired")
                           for m in missed)
            if req is None:
                break
            headroom = (req.deadline - now if req.deadline is not None
                        else None)
            b = self._free.pop()
            ck = req.resume
            slot = _Slot(req=req, table=self._table_for(req), k=0,
                         admit_t=now, headroom_s=headroom)
            self._slots[b] = slot
            if ck is None:
                self.write_slot_rows(b, self._draw_xT(req.seed))
            else:
                # refill the slot's rows from the checkpoint and continue
                # from step k: the same table and tick, so the remaining
                # steps are those the uninterrupted run would have done
                req.resume = None
                if not 0 <= ck.k < req.steps:
                    raise ValueError(
                        f"request {req.request_id}: checkpoint k={ck.k} "
                        f"outside [0, {req.steps})")
                self.write_slot_rows(b, ck.x_rows, ck.hist_rows)
                slot.k = int(ck.k)
                slot.previews = int(ck.previews)
                self._c_resumed.inc()
            wait = (now - req.submit_t if req.submit_t is not None else 0.0)
            self._h_wait.observe(wait)
            ctx = req.trace
            if ctx is not None:
                if self.pool_id is not None:
                    ctx.pool_id = self.pool_id
                if ctx.nfe is None:
                    ctx.nfe = req.steps
                if ctx.plan_digest is None:
                    ctx.plan_digest = _plan_digest(
                        req.resolved_plan(self.schedule, self.clip_x0))
                ctx.emit("admit", now, slot=b, wait_s=wait,
                         headroom_s=headroom)
                if ck is not None:
                    ctx.emit("resume", now, k=int(ck.k),
                             from_pool=ck.pool_id)

    def _states(self) -> StepStates:
        """Every slot's row of its table at its step, as one host buffer
        of int32 columns [t, the five coefficients' float32 bits, seed,
        max_order solver weights' float32 bits] shipped to the device in
        one copy; idle slots take the identity row."""
        B, order = self.slots, self.max_order
        t = np.full((B,), self._idle_row["t"], np.int32)
        cols = np.array([[self._idle_row[k] for k in _COEFS]] * B,
                        np.float32)
        seeds = np.zeros((B,), np.uint32)
        ks = np.zeros((B,), np.uint32)
        solver_w = np.zeros((B, order), np.float32)
        solver_w[:, 0] = 1.0           # idle slots: identity combine
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            tab, k = slot.table, slot.k
            t[b] = tab["t"][k]
            for j, name in enumerate(_COEFS):
                cols[b, j] = tab[name][k]
            seeds[b] = np.uint32(slot.req.seed & 0xFFFFFFFF)
            ks[b] = np.uint32(k)
            w = tab["solver_w"][k]      # (plan order,)
            solver_w[b, :] = 0.0
            solver_w[b, :len(w)] = w
        # per-slot per-tick stream seed: full-avalanche mix of the request
        # seed and the step index (placement-invariant)
        seed = (fmix32_u32(seeds ^ (ks * np.uint32(GOLDEN))).view(np.int32)
                if self.stochastic else np.zeros((B,), np.int32))
        host = np.concatenate([t[:, None], cols.view(np.int32),
                               seed[:, None], solver_w.view(np.int32)], 1)
        dev = torch.from_numpy(host).to(self.device)
        f32 = dev[:, 1:6].view(torch.float32)
        return StepStates(
            t=dev[:, 0], c_x0=f32[:, 0], c_dir=f32[:, 1],
            c_noise=f32[:, 2], sqrt_a_t=f32[:, 3], sqrt_1m_a_t=f32[:, 4],
            seed=dev[:, 6] if self.stochastic else None,
            solver_w=(dev[:, 7:].view(torch.float32) if order > 1
                      else None))

    def _slot_view(self, x2: List[torch.Tensor], b: int) -> torch.Tensor:
        """Slot ``b``'s natural-shape sample from a slot-tile state."""
        rows = self._read_rows(x2, b * self._rps, (b + 1) * self._rps)
        return rows.reshape(-1)[:self._n].reshape(self.shape).clone()

    # --------------------------------------- checkpoint / migrate / cancel
    @property
    def slot_rows_shape(self) -> Tuple[int, int]:
        """One slot's tile-row block shape: (rows_per_slot, 256)."""
        return (self._rps, self._tile_c)

    def resident_requests(self) -> List[Tuple[int, SampleRequest]]:
        """(slot index, request) for every resident slot."""
        return [(b, s.req) for b, s in enumerate(self._slots)
                if s is not None]

    def write_slot_rows(self, b: int, rows, hist_rows=None) -> None:
        """Overwrite slot ``b``'s tile rows (and optionally its
        eps-history rows) in place, in the engine's dtype: the admission
        and checkpoint-restore primitive; a snapshot written back
        reproduces the trajectory exactly."""
        rows = torch.as_tensor(rows).to(device=self.device, dtype=self.dtype)
        if tuple(rows.shape) != (self._rps, self._tile_c):
            raise ValueError(
                f"slot rows must be {(self._rps, self._tile_c)}, got "
                f"{tuple(rows.shape)}")
        lo, hi = b * self._rps, (b + 1) * self._rps
        self._write_rows(self._x2, lo, hi, rows)
        if hist_rows is not None and self._hist2 is not None:
            self._write_rows(self._hist2, lo, hi, torch.as_tensor(
                hist_rows).to(device=self.device, dtype=torch.float32), 1)

    def snapshot_slot(self, b: int,
                      now: Optional[float] = None) -> SlotCheckpoint:
        """Copy slot ``b``'s full trajectory state (tensor copies on the
        engine's device, exact bits)."""
        slot = self._slots[b]
        if slot is None:
            raise ValueError(f"slot {b} is not resident")
        lo, hi = b * self._rps, (b + 1) * self._rps
        hist = (self._read_rows(self._hist2, lo, hi, 1).clone()
                if self._hist2 is not None else None)
        return SlotCheckpoint(
            request_id=slot.req.request_id, k=slot.k,
            x_rows=self._read_rows(self._x2, lo, hi).clone(),
            hist_rows=hist,
            previews=slot.previews, pool_id=self.pool_id, taken_t=now)

    def snapshot_slots(self,
                       now: Optional[float] = None) -> List[SlotCheckpoint]:
        """Checkpoint every resident slot."""
        return [self.snapshot_slot(b, now) for b, s in
                enumerate(self._slots) if s is not None]

    def evict_residents(self) -> List[SampleRequest]:
        """Free every resident slot and hand back its request (no terminal
        accounting: the caller re-routes the work)."""
        out: List[SampleRequest] = []
        for b, slot in enumerate(self._slots):
            if slot is not None:
                out.append(slot.req)
                self._slots[b] = None
                self._free.append(b)
        self._g_active.set(self.active)
        return out

    def cancel(self, request_id, now: Optional[float] = None) -> bool:
        """Free the request's slot (or remove it from the queue); emits a
        terminal ``cancel`` span event.  False when it is not here."""
        now = time.perf_counter() if now is None else now
        for b, slot in enumerate(self._slots):
            if slot is not None and slot.req.request_id == request_id:
                self._slots[b] = None
                self._free.append(b)
                self._g_active.set(self.active)
                self._c_cancelled.inc()
                if slot.req.trace is not None:
                    slot.req.trace.emit("cancel", now, k=slot.k)
                return True
        removed = self.queue.remove_if(
            lambda r: r.request_id == request_id)
        for r in removed:
            self._c_cancelled.inc()
            if r.trace is not None:
                r.trace.emit("cancel", now)
        return bool(removed)

    def _deliver_previews(self, x0_2: List[torch.Tensor],
                          now: float) -> None:
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            req, done = slot.req, slot.k + 1
            if (req.preview_every > 0 and req.on_preview is not None
                    and done < req.steps and done % req.preview_every == 0):
                req.on_preview(req.request_id, done,
                               self._slot_view(x0_2, b))
                slot.previews += 1
                self._c_previews.inc()
                if req.trace is not None:
                    req.trace.emit("preview", now, k=done)

    # -------------------------------------------------- device-probe host
    def _record_frame(self, vals: np.ndarray, now: float) -> None:
        """Host side of the probe path (one small frame per probed tick).

        Folds the (slots, 6) float32 matrix into per-slot quality
        accumulators, the probe gauges, ``last_frame`` and the flight
        recorder's ring.  The defect needs a previous eps of the SAME
        request: at k == 0 the buffer or history row still holds a
        predecessor's (or zero) eval, so the first step's value is
        discarded here.
        """
        spec = self.probe_spec
        self._c_frames.inc()
        slot_map: List[Optional[Dict]] = []
        defect_max = finite_min = None
        for b, slot in enumerate(self._slots):
            if slot is None:
                slot_map.append(None)
                continue
            slot_map.append({"slot": b, "request_id": slot.req.request_id,
                             "k": slot.k})
            row = vals[b]
            slot.q_frames += 1
            if spec.eps_norm and math.isfinite(row[_I_EPS]):
                slot.q_eps_rms = float(row[_I_EPS])
            if spec.finite and math.isfinite(row[_I_FIN]):
                f = float(row[_I_FIN])
                slot.q_finite_min = (f if slot.q_finite_min is None
                                     else min(slot.q_finite_min, f))
                finite_min = (f if finite_min is None
                              else min(finite_min, f))
            if spec.defect and slot.k >= 1 and math.isfinite(row[_I_DEF]):
                d = float(row[_I_DEF])
                slot.q_defect_sum += d
                slot.q_defect_n += 1
                slot.q_defect_max = (d if slot.q_defect_max is None
                                     else max(slot.q_defect_max, d))
                defect_max = (d if defect_max is None
                              else max(defect_max, d))
        if defect_max is not None:
            self._last_defect_max = defect_max
            self._g_defect.set(defect_max)
        if finite_min is not None:
            self._last_finite_min = finite_min
            self._g_finite.set(finite_min)
        frame = {"tick": self.ticks, "now": now, "pool": self.pool_id,
                 "slots": slot_map, "values": vals.tolist()}
        self.last_frame = frame
        if self.flight is not None:
            self.flight.record(frame)

    @staticmethod
    def _slot_quality(slot: _Slot) -> Optional[Dict]:
        """Per-request probe summary attached to SampleResult.quality."""
        if slot.q_frames == 0:
            return None
        return {
            "frames": slot.q_frames,
            "eps_rms_last": slot.q_eps_rms,
            "finite_frac_min": slot.q_finite_min,
            "defect_max": slot.q_defect_max,
            "defect_mean": (slot.q_defect_sum / slot.q_defect_n
                            if slot.q_defect_n else None),
        }

    # ----------------------------------------------------------- the loop
    def tick(self, now: Optional[float] = None) -> List[SampleResult]:
        """One engine tick: admit, advance every resident slot, retire.

        ``now`` drives all timestamps and deadlines (virtual-clock replay);
        in wall-clock mode (now=None) retirement re-stamps after the step.
        """
        wall = now is None
        now = time.perf_counter() if wall else now
        results: List[SampleResult] = []
        self._admit(now, results)
        if self.active == 0:
            return results
        probed = self.probes_on and self.probe_spec is not None
        traces0 = self._traces
        fn = self._tick(probed)
        frame_dev = None
        t0 = time.perf_counter()
        with (annotate(f"repro/tick/{self.tick_variant}")
              if self.obs.profile else contextlib.nullcontext()):
            states = self._states()
            if probed:
                (self._x2, x0_2, self._hist2, frame_dev,
                 self._probe_prev) = fn(self._x2, self._hist2,
                                        self._probe_prev, states,
                                        self.eps_params)
            else:
                self._x2, x0_2, self._hist2 = fn(self._x2, self._hist2,
                                                 states, self.eps_params)
            for dev in self._devices:
                synchronize(dev)
        t1 = time.perf_counter()
        self._c_wall.inc(t1 - t0)
        # EWMA per-step tick latency, the deadline-selection policy's
        # input; a variant's first tick (its build, library set-up) is
        # excluded, as JAX excludes its compile ticks, and so is it from
        # the tick histogram
        if self._traces == traces0:
            self._h_tick.observe(t1 - t0)
            if self.tick_ewma_s is None:
                self.tick_ewma_s = t1 - t0
            else:
                a = self.tick_ewma_alpha
                self.tick_ewma_s = (a * (t1 - t0)
                                    + (1.0 - a) * self.tick_ewma_s)
            self._g_ewma.set(self.tick_ewma_s)
        if wall:
            now = t1
        self._c_ticks.inc()
        self._c_slot_steps.inc(self.active)
        if frame_dev is not None:
            # before the retire loop: every occupied slot's k is the step
            # this frame measured; one device-to-host copy of the frame
            self._record_frame(frame_dev.cpu().numpy(), now)
        if x0_2 is not None:
            self._deliver_previews(x0_2, now)
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.k += 1
            if slot.k == 1 and slot.req.trace is not None:
                slot.req.trace.emit("first_tick", now)
            if slot.k >= slot.req.steps:
                req = slot.req
                missed = (req.deadline is not None and now > req.deadline)
                results.append(SampleResult(
                    request_id=req.request_id,
                    x0=self._slot_view(self._x2, b),
                    S=req.steps, eta=req.eta_label, submit_t=req.submit_t,
                    admit_t=slot.admit_t, finish_t=now,
                    previews=slot.previews, deadline_missed=missed,
                    deadline_headroom_s=slot.headroom_s,
                    auto_plan=req.auto_plan, pool_id=self.pool_id,
                    quality=self._slot_quality(slot)))
                self._c_completed.inc()
                if missed:
                    self._c_miss.inc()
                service = now - slot.admit_t
                self._h_service.observe(service)
                if req.submit_t is not None:
                    self._h_latency.observe(now - req.submit_t)
                if req.deadline is not None:
                    self._h_slack.observe(req.deadline - now)
                if req.trace is not None:
                    req.trace.emit("retire", now, service_s=service,
                                   missed=True if missed else None)
                self._slots[b] = None
                self._free.append(b)
        self._g_active.set(self.active)
        return results

    def run(self, max_ticks: Optional[int] = None,
            now_fn: Optional[Callable[[], float]] = None
            ) -> List[SampleResult]:
        """Tick until the queue and every slot drain (or max_ticks)."""
        results: List[SampleResult] = []
        n = 0
        while len(self.queue) or self.active:
            if max_ticks is not None and n >= max_ticks:
                break
            results.extend(self.tick(now_fn() if now_fn else None))
            n += 1
        return results

    def serve(self, requests: Sequence[SampleRequest],
              now: Optional[float] = None) -> List[SampleResult]:
        """Submit a request list and drain it; back-pressure rejections
        come back as dropped results, so every request has one result."""
        results: List[SampleResult] = []
        for r in requests:
            if not self.submit(r, now=now):
                t = time.perf_counter() if now is None else now
                r.submit_t = t if r.submit_t is None else r.submit_t
                results.append(self._drop(r, t, missed=False))
        results.extend(self.run())
        return results

    def reset_stats(self) -> None:
        """Zero the throughput instruments (e.g. after a warm-up), keeping
        ``compiled_ticks``, the weight-install count, the measured
        ``tick_ewma_s`` and the live gauges; the queue's own counters are
        untouched."""
        keep = {"engine_compiled_ticks_total",
                "engine_weight_installs_total"}
        for inst in self.obs.registry.instruments():
            if (inst.name.startswith("engine_") and inst.kind != "gauge"
                    and inst.name not in keep):
                inst.reset()

    def stats(self) -> Dict:
        denom = max(self.ticks * self.slots, 1)
        return {
            "pool_id": self.pool_id,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "state_sharded": (self._state_sharding is not None
                              and not self._state_sharding.is_replicated),
            "slots": self.slots,
            "active": self.active,
            "ticks": self.ticks,
            "tick_variant": self.tick_variant,
            "slot_steps": self.slot_steps,
            "occupancy": self.slot_steps / denom,
            "completed": self.completed,
            "dropped": self.dropped,
            "cancelled": int(self._c_cancelled.value),
            "resumed": int(self._c_resumed.value),
            "deadline_missed": self.deadline_missed,
            "previews_sent": self.previews_sent,
            "queued": len(self.queue),
            "queue_rejected": self.queue.rejected,
            "tick_wall_s": self._tick_wall_s,
            "tick_ewma_s": self.tick_ewma_s,
            "steps_per_s": self.slot_steps / max(self._tick_wall_s, 1e-9),
            "compiled_ticks": self._traces,
            "plan_bank": (None if self.plan_bank is None
                          else len(self.plan_bank)),
            "bank_selected": self.bank_selected,
            "stochastic": self.stochastic,
            "preview": self.preview,
            "max_order": self.max_order,
            "mega_tick": self.use_mega,
            "dtype": str(self.dtype).replace("torch.", ""),
            "donated": False,
            "probes": (None if self.probe_spec is None
                       else (self.probe_spec.describe() if self.probes_on
                             else "off")),
            "probe_frames": int(self._c_frames.value),
            "probe_defect_max": self._last_defect_max,
            "probe_finite_min": self._last_finite_min,
        }
