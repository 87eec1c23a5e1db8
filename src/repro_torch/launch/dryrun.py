"""Dry run over the production meshes (port of ``repro/launch/dryrun.py``).

For every --arch x shape id x mesh (``launch.mesh.make_production_mesh``:
16 x 16 = 256 cards per pod, 2 x 16 x 16 = 512 over two pods; its devices
are ``meta``) the combo is built on meta tensors in bfloat16, as JAX builds
it: the family's parameters (``shapes.param_specs``; a MoE router stays
float32), the inputs (``input_specs``), the cache (``cache_specs``) and,
for train, the optimizer state (``adamw_init``, or ``adafactor_init``
above ``ADAFACTOR_THRESHOLD`` parameters), each leaf placed by the
name-based rules (``shard_params`` / ``shard_batch`` / ``shard_cache``).
Nothing is allocated and nothing compiles: a rule that does not fit its
leaf fails here, the counterpart of JAX's partitioning errors.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --no-count
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k

One JSON line per combo (``--out``, appended), with the keys of JAX's
record (``dryrun.py:177-199``):

  arch, shape, mesh ("16x16" / "2x16x16"), kind, windowed, opt,
  n_params, n_active (a MoE's routed experts at top_k / n_experts)
  count_s    in place of JAX's lower_s and compile_s: seconds to build
             the combo and count its step (absent under --no-count)
  total_s
  memory     per-device bytes, each leaf at the block that the device at
             mesh coordinates 0 holds: argument_size_in_bytes (train:
             params, optimizer state, rng key, inputs; prefill / decode:
             params, inputs, cache), output_size_in_bytes (train: the new
             state and its float32 metrics; prefill / decode: the logits,
             replicated where JAX's out_shardings replicate them, else
             split as the batch, and the cache); temp_size_in_bytes null:
             no compiler, so activations are not estimated
  roofline   ``roofline.analyze`` (absent under --no-count) of one
             device's share of the step, counted by
             ``roofline.count_per_device`` ("split": "ideal"): flops are
             the whole step's over the chip count; bytes count every
             operand that is an argument leaf (weights, optimizer state,
             cache, inputs, or a view of one) at the block one device
             holds, so a weight split only over "model" is read whole on
             each data replica, and everything the step makes at the chip
             count's share.  No partitioner runs, so what the step makes
             that devices would hold replicated (a train step's gradients
             and new weights) is split too: the memory term is a lower
             bound there.  Collective bytes are ``lm_collective_bytes``'s
             estimate
  counted_at the lengths a count was extended from (below)
  error, traceback on a failure

The step is ``make_lm_train_step`` (``accum_steps`` ``ACCUM_STEPS``, the
default of JAX's ``FLAGS.accum_steps``, which the port's flags do not
carry), ``make_prefill_step`` or ``make_decode_step``.

Long token loops.  The ssm family's forward (rwkv6) loops over tokens in
Python: 288 aten ops a token, so a 32,768-token count would take over
half an hour.  Every op of that loop is per token, so a prefill's flops,
bytes and ops are affine in the length.  A train step's bytes are
quadratic: the backward of each token's slice of a (B, S, d) activation
writes a gradient of the whole (B, S, d), so each of the S tokens moves
O(S) bytes.  Such a combo is counted at the lengths ``COUNT_AT[kind]``:
the polynomial through all but the last (a line for prefill, a parabola
for train) is taken at the combo's length, and the last length checks
it: the count there must lie on it exactly, else the extension raises.
It is the counterpart of ``hlo_analysis.aggregate`` multiplying a
``while`` body by its trip count.  Other combos are counted directly.

``--opt`` sets JAX's perf levers over the production mesh
(``_opt_flags``): the sharding hints, attention chunks of 2,048, MoE
groups of 512; ``runtime_flags.constrain`` then resolves every hint
against that mesh.  JAX's ``decode_inplace`` is left out: the port's
decode always writes its cache in place.  Nothing here imports JAX or
sets an environment variable.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import sys
import time
import traceback
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import configs, prng
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (analyze, count_per_device,
                                         lm_model_flops, no_collectives)
from repro_torch.models import hybrid, moe
from repro_torch.models.common import ArchConfig
from repro_torch.models.runtime_flags import FLAGS, perf_flags
from repro_torch.sharding import (P, NamedSharding, batch_spec, data_axes,
                                  replicated, shard_batch, shard_cache,
                                  shard_params)
from repro_torch.sharding.rules import tree_map_with_path
from repro_torch.training.optim import (AdafactorConfig, AdamWConfig,
                                        adafactor_init, adamw_init)
from repro_torch.training.steps import (TrainState, make_decode_step,
                                        make_lm_train_step,
                                        make_prefill_step)

ADAFACTOR_THRESHOLD = 50e9  # params; above this, train uses Adafactor
ACCUM_STEPS = 1             # JAX's FLAGS.accum_steps default
LOOP_FAMILIES = ("ssm",)    # forward loops over tokens in Python
# the lengths such a loop is counted at: a prefill's count is affine in
# the length, a train step's quadratic; the last length checks the
# polynomial through the others (see the module's docstring)
COUNT_AT = {"prefill": (64, 128, 192), "train": (64, 128, 192, 256)}
MESH_NAMES = {False: "16x16", True: "2x16x16"}
TEMP_NOTE = "no compiler: activations are not estimated"


def _leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a tree, paths "/"-joined as the rules read them."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _count(tree) -> int:
    return int(sum(leaf.numel() for _, leaf in _leaves(tree)))


def active_params(param_shapes, cfg: ArchConfig) -> int:
    """Active parameter count (MoE: top_k of n_experts routed)."""
    total, expert = 0, 0
    for pstr, leaf in _leaves(param_shapes):
        n = leaf.numel()
        total += n
        last = pstr.split("/")[-1]
        if "/moe/" in pstr and not last.startswith("sw") and last != "router":
            expert += n
    if cfg.n_experts:
        return total - expert + int(expert * cfg.top_k / cfg.n_experts)
    return total


def block_shape(leaf: torch.Tensor, sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """Shape of the block of ``leaf`` that the device at mesh coordinates
    0 holds under ``sharding`` (every block has its shape)."""
    idx = sharding.index((0,) * len(sharding.mesh.shape), leaf.shape)
    return tuple(s.stop - s.start for s in idx)


def block_bytes(leaf: torch.Tensor, sharding: NamedSharding) -> int:
    return math.prod(block_shape(leaf, sharding)) * leaf.element_size()


Block = Tuple[torch.Tensor, Tuple[int, ...]]   # a leaf, its block's shape


def _blocks(tree, shardings) -> List[Block]:
    """(leaf, block shape) of every leaf of ``tree``."""
    out = []
    tree_map_with_path(
        lambda _, leaf, s: out.append((leaf, block_shape(leaf, s))),
        tree, shardings)
    return out


def held(blocks: List[Block]) -> List[Tuple[torch.Tensor, int]]:
    """(leaf, bytes of its block) of every block."""
    return [(leaf, math.prod(shape) * leaf.element_size())
            for leaf, shape in blocks]


def blocks_bytes(blocks: List[Block]) -> int:
    return sum(n for _, n in held(blocks))


def _logits_sharding(combo: shp.Combo, mesh) -> NamedSharding:
    """The (B, vocab) logits' sharding: replicated where JAX's prefill
    out_shardings replicate them (a batch the mesh does not divide), else
    split as the batch."""
    if combo.kind == "prefill" and combo.batch % mesh.size:
        return replicated(mesh)
    return NamedSharding(mesh, batch_spec(mesh, combo.batch, 2))


@dataclasses.dataclass
class Built:
    """One combo on meta tensors: the step, its arguments, every argument
    leaf with the shape of its block on one device, and the output
    bytes."""
    fn: object
    args: tuple
    params: Dict
    inputs: Dict
    n_params: int
    n_active: int
    argument_blocks: List[Block]
    output_bytes: int

    @property
    def argument_bytes(self) -> int:
        return blocks_bytes(self.argument_blocks)


def build(combo: shp.Combo, mesh, dtype=torch.bfloat16) -> Built:
    """The combo's step and meta arguments on ``mesh`` with their
    per-device sizes (the module's docstring)."""
    cfg = combo.arch
    params = shp.param_specs(cfg, dtype)
    p_blocks = _blocks(params, shard_params(params, mesh))
    inputs = shp.input_specs(combo, dtype)
    in_blocks = _blocks(inputs, shard_batch(inputs, mesh))
    n_params = _count(params)
    n_active = active_params(params, cfg)
    if combo.kind == "train":
        if n_params > ADAFACTOR_THRESHOLD:
            opt_cfg, opt_init, n_metrics = AdafactorConfig(), adafactor_init, 3
        else:
            opt_cfg, opt_init, n_metrics = AdamWConfig(), adamw_init, 4
        opt = opt_init(params)
        rng = prng.PRNGKey(0, "meta")
        state = (p_blocks + _blocks(opt, shard_params(opt, mesh))
                 + [(rng, tuple(rng.shape))])
        step = make_lm_train_step(cfg, opt_cfg, accum_steps=ACCUM_STEPS)
        return Built(step, (TrainState(params, opt, rng), inputs), params,
                     inputs, n_params, n_active, state + in_blocks,
                     blocks_bytes(state) + 4 * n_metrics)
    cache = shp.cache_specs(combo, dtype)
    c_blocks = _blocks(cache, shard_cache(cache, mesh, combo.batch))
    logits = torch.empty((combo.batch, cfg.vocab), dtype=dtype,
                         device="meta")
    out_bytes = (block_bytes(logits, _logits_sharding(combo, mesh))
                 + blocks_bytes(c_blocks))
    if combo.kind == "prefill":
        args = (params, inputs["tokens"], cache, inputs.get("embeds"))
        fn = make_prefill_step(cfg)
    else:
        args = (params, inputs["tokens"], cache)
        fn = make_decode_step(cfg)
    return Built(fn, args, params, inputs, n_params, n_active,
                 p_blocks + in_blocks + c_blocks, out_bytes)


def _poly(points: List[Tuple[int, Fraction]], s: int) -> Fraction:
    """The polynomial through ``points`` ((length, count) pairs, degree
    len - 1) at length ``s``, in exact arithmetic."""
    total = Fraction(0)
    for i, (si, vi) in enumerate(points):
        w = Fraction(vi)
        for j, (sj, _) in enumerate(points):
            if j != i:
                w *= Fraction(s - sj, si - sj)
        total += w
    return total


def _extend(points: List[Tuple[int, Fraction]], s: int) -> Fraction:
    """The polynomial through all but the last of ``points`` at length
    ``s``; the last point checks it, and a count off it raises."""
    *fit, (s_chk, v_chk) = points
    got = _poly(fit, s_chk)
    if got != v_chk:
        raise ValueError(
            f"counts {points}: the polynomial through the first {len(fit)} "
            f"gives {got} at length {s_chk}, not {v_chk}: not of degree "
            f"{len(fit) - 1}")
    return _poly(fit, s)


def count_step(combo: shp.Combo, mesh, dtype=torch.bfloat16
               ) -> Tuple[Dict, List[int]]:
    """``roofline.count_per_device`` of the combo's step on ``mesh``, and
    the lengths it was counted at ([] for a direct count; ``COUNT_AT[kind]``
    where a Python token loop is extended from them).  ``device_bytes`` is
    a ``Fraction``; the other keys are integers."""
    def counted(b: Built) -> Dict:
        return count_per_device(b.fn, b.args, mesh.size,
                                held(b.argument_blocks))

    lengths = COUNT_AT.get(combo.kind, ())
    if (combo.arch.family in LOOP_FAMILIES and lengths
            and combo.seq_len > lengths[-1]):
        at = [counted(build(dataclasses.replace(combo, seq_len=s), mesh,
                            dtype)) for s in lengths]
        out = {k: _extend([(s, c[k]) for s, c in zip(lengths, at)],
                          combo.seq_len) for k in at[0]}
        return ({k: v if k == "device_bytes" else int(v)
                 for k, v in out.items()}, list(lengths))
    return counted(build(combo, mesh, dtype)), []


def _positions(path: str, cfg: ArchConfig, n_text: int, n_emb: int) -> int:
    """Positions per sample that pass through the weight at ``path``."""
    if cfg.family == "vlm":
        return n_text + n_emb
    if cfg.family == "audio" and path.startswith("enc_"):
        return n_emb
    return n_text


def lm_collective_bytes(combo: shp.Combo, mesh, params: Dict,
                        inputs: Dict) -> Dict[str, int]:
    """Per-device collective bytes that the sharding specs of ``params``
    (``shard_params``) and of the batch (``batch_spec``) imply for one
    step, in JAX's collective dict.  An estimate: no partitioner runs.
    With b the batch block (the batch over the data axes where they
    divide it, else whole), s a weight's positions per sample (text tokens;
    a vlm's layers also its image embeddings; an audio encoder's layers
    its frames, none in decode) and a the weight's applications (its
    stacked leading dims; the hybrid's shared block ``n_apps`` times):

      * "all-reduce" over "model" of each product whose weight is split on
        its contracted dim ((K, N) with K over "model": ``wo``,
        ``w_down``, ``sw_down``, ``w_out``): a x b x s x N elements;
      * "all-reduce" of the vocab-split ``embed`` gather (each device
        holds its vocab slice's rows): b x s x d, once;
      * "all-to-all" each way (dispatch and combine) for expert-parallel
        MoE weights (the expert dim over "model"), once per MoE layer: the
        (E, G, C, d) expert input's block, E over "model", the G routing
        groups (``FLAGS.moe_group``) over the data axes where they divide;
      * train: the backward's mirror of each of those (one more of each),
        and an "all-reduce" over the data axes of every leaf's gradient
        block (its per-device parameter block), when they hold more than
        one device.

    Elements are the weight's bytes each.  Not counted: the gathers of
    an activation whose producer splits what its consumer contracts
    whole (rwkv6's channel-mix ``wv``), vocab-parallel logits (gathered
    for serving, reduced in the loss), the ``seq_parallel_spec`` gathers
    of ``--opt``, and DCN or InfiniBand hops: every byte is priced at
    the NVLink rate, as JAX prices its ``pod`` axis at the ICI rate.
    ``count`` is the number of collectives."""
    cfg = combo.arch
    placed = []
    tree_map_with_path(lambda p, leaf, sh: placed.append((p, leaf, sh)),
                       params, shard_params(params, mesh))
    daxes = data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    msize = mesh.shape["model"]
    b = combo.batch // dsize if combo.batch % dsize == 0 else combo.batch
    n_text = inputs["tokens"].shape[1]
    n_emb = inputs["embeds"].shape[1] if "embeds" in inputs else 0
    train = combo.kind == "train"
    passes = 2 if train else 1
    out = no_collectives()

    def add(kind, n_bytes, times):
        if n_bytes and times:
            out[kind] += n_bytes * times
            out["count"] += times

    for path, leaf, sharding in placed:
        spec = tuple(sharding.spec)
        isz = leaf.element_size()
        if re.search(r"(^|/)embed$", path):
            if spec and spec[0] == "model":
                add("all-reduce", b * n_text * leaf.shape[-1] * isz, passes)
        elif re.search(r"/moe/w_down$", path) and "model" in spec:
            n_tok = combo.batch * n_text
            group = min(FLAGS.moe_group or moe.MOE_GROUP, n_tok)
            groups = -(-n_tok // group)
            g_blk = groups // dsize if groups % dsize == 0 else groups
            per_way = ((cfg.n_experts // msize) * g_blk
                       * moe._capacity(cfg, group) * cfg.d_model * isz)
            add("all-to-all", per_way,
                2 * passes * math.prod(leaf.shape[:-3]))
        elif len(spec) >= 2 and spec[-2] == "model":
            apps = math.prod(leaf.shape[:-2])
            if cfg.family == "hybrid" and path.startswith("shared/"):
                apps *= hybrid.n_apps(cfg)
            s = _positions(path, cfg, n_text, n_emb)
            add("all-reduce", b * s * leaf.shape[-1] * isz, apps * passes)
        if train and dsize > 1:
            add("all-reduce", block_bytes(leaf, sharding), 1)
    return out


def _opt_flags(mesh, combo: shp.Combo) -> Dict:
    """JAX's --opt lever settings (``dryrun.py:146-161``) but
    ``decode_inplace``, which the port does not have."""
    daxes = data_axes(mesh)
    batch_ax = daxes if combo.batch % int(
        np.prod([mesh.shape[a] for a in daxes])) == 0 else None
    return dict(
        seq_parallel_spec=P(batch_ax, "model", None),
        attn_chunk=2048,
        moe_group=512,
        exp_in_spec=P("model", batch_ax, None, None),
        dispatch_spec=P(batch_ax, None, "model", None),
        mesh=mesh,
    )


def run_combo(arch_id: str, shape_id: str, multi_pod: bool,
              count_: bool = True, opt: bool = False) -> Dict:
    """One combo's record (the module's docstring)."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    combo = shp.resolve(configs.get(arch_id), shape_id)
    with (perf_flags(**_opt_flags(mesh, combo)) if opt
          else contextlib.nullcontext()):
        b = build(combo, mesh)
        rec = {
            "arch": arch_id, "shape": shape_id,
            "mesh": MESH_NAMES[multi_pod], "kind": combo.kind,
            "windowed": combo.windowed, "opt": opt,
            "n_params": b.n_params, "n_active": b.n_active,
            "memory": {"argument_size_in_bytes": b.argument_bytes,
                       "output_size_in_bytes": b.output_bytes,
                       "temp_size_in_bytes": None,
                       "temp_size_note": TEMP_NOTE},
        }
        if count_:
            counts, counted_at = count_step(combo, mesh)
            rec["count_s"] = round(time.time() - t0, 1)
            n_tokens = combo.batch * (1 if combo.kind == "decode"
                                      else combo.seq_len)
            mflops = lm_model_flops(
                b.n_active, n_tokens,
                "train" if combo.kind == "train" else "serve")
            per_device = {"flops": counts["flops"] / mesh.size,
                          "traffic_bytes": float(counts["device_bytes"])}
            terms = analyze(per_device, mesh.size, model_flops=mflops,
                            dtype=torch.bfloat16,
                            coll=lm_collective_bytes(combo, mesh, b.params,
                                                     b.inputs))
            rec["roofline"] = {**terms.as_dict(), "split": "ideal"}
            if counted_at:
                rec["counted_at"] = counted_at
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=shp.SHAPE_IDS)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--no-count", action="store_true",
                    help="records without the roofline (JAX's --no-compile)")
    ap.add_argument("--opt", action="store_true",
                    help="enable the perf levers (sequence-parallel hint, "
                         "chunked attention, MoE hints)")
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[
        args.mesh]
    if args.all:
        combos = [(a, s, mp) for a in configs.ARCH_IDS
                  for s in shp.SHAPE_IDS for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    out_f = open(args.out, "a") if args.out else None
    failures = 0
    for a, s, mp in combos:
        tag = f"{a} x {s} x {MESH_NAMES[mp]}"
        try:
            rec = run_combo(a, s, mp, count_=not args.no_count, opt=args.opt)
            r = rec.get("roofline", {})
            print(f"OK   {tag}: bottleneck={r.get('bottleneck')} "
                  f"compute={r.get('compute_s', 0):.3e}s "
                  f"memory={r.get('memory_s', 0):.3e}s "
                  f"coll={r.get('collective_s', 0):.3e}s "
                  f"(count {rec.get('count_s')}s total {rec['total_s']}s)",
                  flush=True)
        except Exception as e:
            failures += 1
            rec = {"arch": a, "shape": s, "mesh": MESH_NAMES[mp],
                   "error": repr(e), "traceback": traceback.format_exc()}
            print(f"FAIL {tag}: {e!r}", flush=True)
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
        gc.collect()
    if out_f:
        out_f.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
