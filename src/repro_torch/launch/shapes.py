"""Assigned input shapes and per-(arch x shape) stand-ins (port of
``repro/launch/shapes.py``).

  train_4k     seq_len=4096    global_batch=256   (training)
  prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768   global_batch=128   (inference-decode)
  long_500k    seq_len=524288  global_batch=1     (long-context-decode)

Decode shapes run ``decode_step`` (ONE token against a seq_len cache).
long_500k policy: native for ssm/hybrid; dense/moe/vlm/audio run a
sliding-window (8192) variant — marked via ``windowed`` in the combo.

For stub-frontend archs: vlm gets (B, n_ctx_embeds, d) patch embeddings and
text length seq_len - n_ctx_embeds (total positions == seq_len); audio
splits the budget between encoder frames and decoder text for train/prefill
and uses the decoder cache for decode shapes.

The stand-ins are tensors on the ``meta`` device: JAX's shapes and dtypes
with no allocation, so a full-size combo can be sized (or counted by
``launch.roofline.count``) on any host; ``param_specs`` gives the
model's weights the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.common import ArchConfig

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

SHAPE_IDS = list(SHAPES)
WINDOW = 8192  # sliding-window size for the long_500k dense variant
AUDIO_PREFILL_TOKENS = 256   # decoder prompt of an audio prefill combo
AUDIO_PREFILL_NEW = 64       # decoder cache room past that prompt


@dataclasses.dataclass(frozen=True)
class Combo:
    """One (architecture x input shape) combination."""
    arch: ArchConfig
    shape_id: str
    kind: str            # train | prefill | decode
    batch: int
    seq_len: int
    windowed: bool       # sliding-window long_500k variant


def resolve(cfg: ArchConfig, shape_id: str) -> Combo:
    s = SHAPES[shape_id]
    windowed = False
    if shape_id == "long_500k" and cfg.family not in ("ssm",):
        # hybrid keeps full shared-attn KV (9 apps, sub-quadratic overall);
        # every full-attention family gets the window variant.
        if cfg.family != "hybrid":
            cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
            windowed = True
    return Combo(arch=cfg, shape_id=shape_id, kind=s["kind"],
                 batch=s["global_batch"], seq_len=s["seq_len"],
                 windowed=windowed)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embeds(cfg: ArchConfig, batch: int, n: int, dtype) -> torch.Tensor:
    return _meta((batch, n, cfg.d_model), dtype)


def input_specs(combo: Combo, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this combo (JAX's
    shapes and dtypes, zero allocation)."""
    cfg, B, L = combo.arch, combo.batch, combo.seq_len
    tokens = lambda n: _meta((B, n), torch.int32)  # noqa: E731
    if combo.kind == "train":
        if cfg.family == "vlm":
            n_img = cfg.n_ctx_embeds
            return {"tokens": tokens(L - n_img),
                    "embeds": _embeds(cfg, B, n_img, dtype)}
        if cfg.family == "audio":
            return {"tokens": tokens(L // 2),
                    "embeds": _embeds(cfg, B, L // 2, dtype)}
        return {"tokens": tokens(L)}
    if combo.kind == "prefill":
        if cfg.family == "vlm":
            n_img = cfg.n_ctx_embeds
            return {"tokens": tokens(L - n_img),
                    "embeds": _embeds(cfg, B, n_img, dtype)}
        if cfg.family == "audio":
            # encoder takes the 32k frames; decoder prompt is short
            return {"tokens": tokens(AUDIO_PREFILL_TOKENS),
                    "embeds": _embeds(cfg, B, L, dtype)}
        return {"tokens": tokens(L)}
    # decode: one new token
    return {"tokens": tokens(1)}


def param_specs(cfg: ArchConfig, dtype=torch.float32) -> Dict:
    """The family's parameter tree as meta tensors: ``init_params``'s
    leaves, shapes and dtypes (a MoE router stays float32), drawn from the
    family's ``param_shapes`` table, not from the init's draws."""
    from repro_torch.models import dense, encdec, hybrid, moe, rwkv6
    table = {"dense": dense, "vlm": dense, "moe": moe, "ssm": rwkv6,
             "hybrid": hybrid, "audio": encdec}[cfg.family]

    def build(tree, name=""):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        return _meta(tree, torch.float32 if name == "router" else dtype)
    return build(table.param_shapes(cfg))


def cache_specs(combo: Combo, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The family's cache (or recurrent state) for this combo, as meta
    tensors: ``init_cache`` run on the ``meta`` device."""
    from repro_torch.models import encdec, get_api
    cfg = combo.arch
    if cfg.family == "audio" and combo.kind == "prefill":
        # cross cache must match the encoder frame count of this combo
        return encdec.init_cache(cfg, combo.batch,
                                 AUDIO_PREFILL_TOKENS + AUDIO_PREFILL_NEW,
                                 combo.seq_len, dtype, "meta")
    return get_api(cfg).init_cache(cfg, combo.batch, combo.seq_len,
                                   dtype=dtype, device="meta")


def nbytes(tree) -> int:
    """Total bytes of a (nested dict of) tensors, meta or real."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
