"""DDIM over latent token sequences with a backbone eps-trunk (port of
``repro/diffusion_lm/model.py``: every family's trunk).

Tokens embed into a small continuous latent (Diffusion-LM, Li et al.
2022); the sampler runs on those latents; a trunk with additive time
conditioning predicts the noise:
  dense / vlm / audio -> bidirectional dense transformer layers;
  moe         -> MoE layers (``models/moe.py``), their attention MLA
                 (causal, as JAX's trunk calls ``mla_forward``) or
                 bidirectional GQA;
  ssm         -> rwkv6 layers (``models/rwkv6.py``), each from a fresh
                 zero state per call (a causal recurrence);
  hybrid      -> Mamba2 layers only (``models/hybrid.py``), each from
                 fresh zero states, with no shared attention (causal).
The parameters are a dict mirroring the JAX pytree: (in, out) matrices
used as ``x @ w``, the layers' leaves stacked along a leading
``n_layers`` axis.  Plain matrix products stay ``torch.matmul``, as the
JAX package left them to XLA; the hand-written kernels run inside
``backend='mega'`` (kernels/megastep, dense trunks only: a moe, ssm or
hybrid trunk carries no ``mega_spec`` and runs the tile-resident loop,
B1 per step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.core.diffusion import q_sample
from repro_torch.core.sampler import SamplerConfig, sample
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sampler_step.ref import SUBLANE, TILE_C
from repro_torch.models import dense, hybrid, mamba2, moe, rwkv6
from repro_torch.models.attention import gqa_forward, mla_forward
from repro_torch.models.common import (ArchConfig, KeyGen, dense_init,
                                       embed_init, matmul, rms_norm,
                                       sinusoidal_time_embedding,
                                       stack_layer_params, stacked)

Params = Dict[str, object]

# the eps path's weights: what the sampler loop (and the megakernel) reads
EPS_PATH = ("w_in", "time_w1", "time_w2", "layers", "out_norm", "w_out")
_DENSE_FAMILIES = ("dense", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class DiffusionLMConfig:
    arch: ArchConfig
    time_dim: int = 256
    latent_dim: int = 32           # Diffusion-LM: diffuse in a SMALL latent


def _trunk_layer(a: ArchConfig):
    """(one trunk layer's init from a key, its leaves' shapes) of the
    family; ValueError for a family the JAX trunk does not know."""
    if a.family in _DENSE_FAMILIES:
        return dense.init_layer, dense.layer_shapes
    trunks = {"moe": (moe.init_layer, moe.layer_shapes),
              "ssm": (rwkv6.init_layer, rwkv6.layer_shapes),
              "hybrid": (hybrid.init_mamba_layer, hybrid.mamba_layer_shapes)}
    if a.family not in trunks:
        raise ValueError(a.family)
    return trunks[a.family]


def init_params(key: torch.Tensor, cfg: DiffusionLMConfig,
                device: DeviceLike = None,
                dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers for a threefry key,
    drawn and stored on ``device`` (CUDA unless named): the heads in its
    key order, then ``n_layers`` stacked layers of the family's trunk."""
    init_layer, _ = _trunk_layer(cfg.arch)
    dev = resolve_device(device)
    a = cfg.arch
    kg = KeyGen(key.to(dev))
    params: Params = {
        "embed": embed_init(kg(), (a.vocab, cfg.latent_dim), dtype),
        "w_in": dense_init(kg(), (cfg.latent_dim, a.d_model), dtype),
        "time_w1": dense_init(kg(), (cfg.time_dim, cfg.time_dim), dtype),
        "time_w2": dense_init(kg(), (cfg.time_dim, a.d_model), dtype),
        "out_norm": torch.ones((a.d_model,), dtype=dtype, device=dev),
        "w_out": dense_init(kg(), (a.d_model, cfg.latent_dim), dtype),
        "rounding": dense_init(kg(), (cfg.latent_dim, a.vocab), dtype),
    }
    params["layers"] = stack_layer_params(
        lambda k: init_layer(k, a, dtype), a.n_layers, kg)
    return params


def param_shapes(cfg: DiffusionLMConfig) -> Dict[str, object]:
    """The parameter tree as nested dicts of shapes (stacked layer leaves
    lead with n_layers), as the JAX ``init_params`` builds it."""
    a = cfg.arch
    d, L, T = a.d_model, cfg.latent_dim, cfg.time_dim
    layers = stacked(_trunk_layer(a)[1](a), a.n_layers)
    return {
        "embed": (a.vocab, L), "w_in": (L, d), "time_w1": (T, T),
        "time_w2": (T, d), "out_norm": (d,), "w_out": (d, L),
        "rounding": (L, a.vocab), "layers": layers,
    }


def _moe_layer_fwd(layer: Dict, a: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """One MoE trunk layer (``diffusion_lm/model.py:93-104``)."""
    xn = rms_norm(x, layer["attn_norm"], a.norm_eps)
    if a.use_mla:
        x = x + mla_forward(layer["attn"], a, xn, positions)
    else:
        x = x + gqa_forward(layer["attn"], a, xn, positions, causal=False)
    y, _ = moe.moe_ffn(layer["moe"], a,
                       rms_norm(x, layer["mlp_norm"], a.norm_eps))
    return x + y


def _mamba_layer_fwd(layer: Dict, a: ArchConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """One hybrid trunk layer: Mamba2 from zero states
    (``diffusion_lm/model.py:115-122``)."""
    conv, ssm = mamba2.init_mamba_state(a, x.shape[0], x.dtype, x.device)
    y, _, _ = mamba2.mamba_forward(layer["mamba"], a,
                                   rms_norm(x, layer["norm"], a.norm_eps),
                                   conv, ssm)
    return x + y


def _layer_fwd(layer: Dict, a: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    if a.family in _DENSE_FAMILIES:
        return dense.layer_fwd(layer, a, x, positions, False)
    if a.family == "moe":
        return _moe_layer_fwd(layer, a, x, positions)
    if a.family == "ssm":
        return rwkv6.layer_fwd(layer, a, x)
    if a.family == "hybrid":
        return _mamba_layer_fwd(layer, a, x)
    raise ValueError(a.family)


def eps_forward(params: Params, cfg: DiffusionLMConfig, x_t: torch.Tensor,
                t: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """eps prediction over latent sequences. x_t: (B,S,d); t: (B,) int.
    ``remat`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the layer
    scan): less memory, the same numbers.  A state and weights of two
    types promote as in JAX (``models.common.matmul``): a bfloat16 state
    over float32 weights, or the reverse, runs the trunk in float32."""
    a = cfg.arch
    temb = sinusoidal_time_embedding(t, cfg.time_dim).to(x_t.dtype)
    temb = matmul(F.silu(matmul(temb, params["time_w1"])),
                  params["time_w2"])
    h = matmul(x_t, params["w_in"]) + temb[:, None, :]
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    for layer in dense.unstack_layers(params["layers"], a.n_layers):
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer_fwd, layer, a, h, positions,
                           use_reentrant=False)
        else:
            h = _layer_fwd(layer, a, h, positions)
    h = rms_norm(h, params["out_norm"], a.norm_eps)
    return matmul(h, params["w_out"])


def make_eps_fn(params: Params, cfg: DiffusionLMConfig):
    def eps_fn(x, t):
        with torch.no_grad():
            return eps_forward(params, cfg, x, t)
    return eps_fn


def make_tile_eps_fn(params: Params, cfg: DiffusionLMConfig, batch: int,
                     seq_len: int):
    """Tile-aware eps model: consumes the (R, 256) tile view directly.

    Valid when ``seq_len * latent_dim`` is a multiple of the 8 x 256 tile
    granule, so the tile view (and the scheduler's slot-tile view) is a
    pure reshape of (batch, seq_len, latent_dim).  ``t`` may be a scalar
    (the tile-resident loop) or a (batch,) vector (the scheduler: every
    slot at its own timestep).  A dense-family trunk also carries
    ``eps_fn.mega_spec`` (the eps-path weights and the bound geometry, for
    ``backend='mega'``) and ``eps_fn.mega_vmem_bytes``, the byte model the
    eligibility rule holds against ``MEGA_BUDGET``; a moe trunk carries
    neither (nor does an ssm or hybrid trunk), so 'mega' runs it on the
    tile-resident loop, as in JAX.
    """
    n = seq_len * cfg.latent_dim
    granule = SUBLANE * TILE_C
    if n % granule:
        raise ValueError(
            f"tile-aware diffusion-LM needs seq_len*latent_dim divisible by "
            f"{granule}, got {seq_len}*{cfg.latent_dim}={n}; use "
            f"make_eps_fn (adapter path) for unaligned shapes")
    shape = (batch, seq_len, cfg.latent_dim)

    def eps_fn(x2, t):
        t = torch.as_tensor(t, dtype=torch.int32,
                            device=x2.device).reshape(-1).expand(batch)
        with torch.no_grad():
            e = eps_forward(params, cfg, x2.reshape(shape), t)
        return e.reshape(x2.shape)

    eps_fn.tile_aware = True        # tile-resident loop (backends.py)
    eps_fn.slot_tile_aware = True   # scheduler slot layout (serving)
    if cfg.arch.family in _DENSE_FAMILIES:
        from repro_torch.kernels.megastep import MegaSpec
        spec = MegaSpec(params={k: params[k] for k in EPS_PATH}, cfg=cfg,
                        batch=batch, seq_len=seq_len)
        eps_fn.mega_spec = spec
        eps_fn.mega_vmem_bytes = spec.vmem_bytes()
    return eps_fn


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Tokens -> unit-scale latents (x0 of the diffusion)."""
    e = params["embed"][tokens]
    return e / (torch.std(e, dim=-1, keepdim=True, correction=0) + 1e-6)


def round_to_tokens(params: Params, x0: torch.Tensor) -> torch.Tensor:
    """Latents -> int32 tokens via the rounding head (Diffusion-LM); a
    float32 x0 over bfloat16 weights promotes, as in JAX."""
    return torch.argmax(matmul(x0, params["rounding"]),
                        dim=-1).to(torch.int32)


def training_loss(params: Params, cfg: DiffusionLMConfig,
                  schedule: NoiseSchedule, tokens: torch.Tensor,
                  rng: torch.Tensor, rounding_weight: float = 1.0,
                  remat: bool = True):
    """L_simple on latents + the rounding cross-entropy (keeps latents
    decodable); paper Eq. 5 with gamma = 1.  Returns (loss, {"l_eps",
    "l_round"}).  (t, eps) come from ``split(rng)`` as in JAX; the forward
    runs with autograd on."""
    k_t, k_e = prng.split(rng)
    x0 = embed_tokens(params, tokens)
    t = prng.randint(k_t, (tokens.shape[0],), 1, schedule.T + 1)
    noise = prng.normal(k_e, x0.shape, dtype=x0.dtype).to(x0.device)
    t = t.to(x0.device)
    x_t = q_sample(schedule, x0, t, noise)
    eps_hat = eps_forward(params, cfg, x_t, t, remat=remat)
    l_eps = torch.mean(torch.square(eps_hat - noise))
    logits = x0 @ params["rounding"]
    l_round = -torch.mean(torch.gather(
        torch.log_softmax(logits, dim=-1), -1,
        tokens.long()[..., None]))
    loss = l_eps + rounding_weight * l_round
    return loss, {"l_eps": l_eps, "l_round": l_round}


def generate(params: Params, cfg: DiffusionLMConfig,
             schedule: NoiseSchedule, rng: torch.Tensor,
             batch: int, seq_len: int,
             sampler: Optional[SamplerConfig] = None,
             tile_resident: bool = False,
             device: DeviceLike = None) -> torch.Tensor:
    """Sample (batch, seq_len) int32 token sequences with the DDIM process.

    Runs on ``device`` (CUDA unless named), where ``params`` must lie.
    ``k_init, k_samp = split(rng)``: x_T is ``normal(k_init)`` and the
    sampler runs with ``k_samp``, as in JAX.  ``tile_resident=True`` runs
    the loop in the tile layout with the tile-aware eps model when the
    latent aligns to the tile granule (the adapter path otherwise), on
    ``backend='mega'``: eligible trunks run fused, everything else the
    tile-resident loop.
    """
    dev = resolve_device(device)
    on = params["w_in"].device
    if on.type != dev.type or (None not in (on.index, dev.index)
                               and on.index != dev.index):
        raise ValueError(f"params lie on {on}, not on {dev}")
    sampler = sampler or SamplerConfig(S=50, eta=0.0)
    k_init, k_samp = prng.split(rng.to(dev))
    x_T = prng.normal(k_init, (batch, seq_len, cfg.latent_dim))
    if tile_resident:
        try:
            eps_fn = make_tile_eps_fn(params, cfg, batch, seq_len)
        except ValueError:   # unaligned latent: adapter path still works
            eps_fn = make_eps_fn(params, cfg)
        x0 = sample(schedule, eps_fn, x_T, sampler, k_samp,
                    tile_resident=True, backend="mega")
    else:
        x0 = sample(schedule, make_eps_fn(params, cfg), x_T, sampler,
                    k_samp)
    return round_to_tokens(params, x0)
