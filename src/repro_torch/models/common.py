"""Shared model building blocks (port of ``repro/models/common.py``).

The sinusoidal time embedding (U-Net and diffusion-LM), the architecture
config, the trunk numerics (RMSNorm, LayerNorm, SwiGLU, rotary
embeddings, the causal mask) and the inits.  Each keeps the JAX function's op order,
so float32 results differ only by the order of the sums inside matrix
products.  The inits take a threefry key (``repro_torch.prng``) and draw
JAX's numbers: ``dense_init`` / ``embed_init`` are ``truncated_normal`` /
``normal`` in float32, scaled, then cast, and ``KeyGen`` /
``stack_layer_params`` hand out keys in JAX's order.  A draw runs where
its key lies, in chunks of ``INIT_CHUNK`` elements over the counter
range, so a leaf of a billion elements never holds more than one chunk's
threefry words.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng

# elements per threefry draw: 2**26 int64 counters are 512 MB a word
INIT_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (``repro/models/common.py:22``): every field the
    dense, MoE (MLA), VLM, SSM (rwkv6), hybrid (Mamba2 + shared attention)
    and enc-dec families read, with JAX's defaults.
    """

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""
    head_dim: Optional[int] = None  # default d_model // n_heads
    tie_embeddings: bool = False   # logits = h @ embed.T (no "unembed")
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek-style latent attention) ---
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0            # hybrid: shared attn block period
    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- vlm / audio frontends (stubs: embeddings arrive precomputed) ---
    n_ctx_embeds: int = 0          # image patch / audio frame token count
    # --- serving ---
    sliding_window: int = 0        # 0 = full attention

    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> None:
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.use_mla:
            assert self.kv_lora > 0


def causal_mask(S: int, dtype=torch.float32, window: int = 0,
                device=None) -> torch.Tensor:
    """(S, S) additive mask; optional sliding window (local attention)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window:
        ok &= j > i - window
    return torch.where(ok, 0.0, float("-inf")).to(dtype)


_THREADS_LOCK = threading.Lock()
_threads_depth = 0      # CPU draws in flight, across threads
_threads_saved = 1      # the intra-op thread count before the first of them


@contextlib.contextmanager
def _one_cpu_thread(device: torch.device):
    """Run a CPU draw on one intra-op thread.  A threefry draw is ~300
    small elementwise ops, which gain nothing from OpenMP threads and lose
    everything when processes share the cores: a smoke init took 0.77 s
    on one thread, 1.31 s on eight, and 249 s in each of six processes of
    eight threads on eight cores.  The thread count is process-wide, so
    draws in flight are counted under a lock: the first saves it, the
    last restores it."""
    global _threads_depth, _threads_saved
    if device.type != "cpu":
        yield
        return
    with _THREADS_LOCK:
        if _threads_depth == 0:
            _threads_saved = torch.get_num_threads()
            torch.set_num_threads(1)
        _threads_depth += 1
    try:
        yield
    finally:
        with _THREADS_LOCK:
            _threads_depth -= 1
            if _threads_depth == 0:
                torch.set_num_threads(_threads_saved)


def _draw(key: torch.Tensor, shape: Tuple[int, ...], dtype, scale: float,
          draw: Callable, chunk: int) -> torch.Tensor:
    """``(draw(key, shape) * scale).astype(dtype)`` on the key's device,
    drawn ``chunk`` elements at a time over the row-major counter range
    (the same numbers as one draw)."""
    out = torch.empty(shape, dtype=dtype, device=key.device)
    flat = out.view(-1)
    n = flat.numel()
    with _one_cpu_thread(key.device):
        for a in range(0, n, chunk):
            m = min(chunk, n - a)
            flat[a:a + m] = (draw(key, (m,), start=a) * scale).to(dtype)
    return out


def dense_init(key: torch.Tensor, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None,
               chunk: int = INIT_CHUNK) -> torch.Tensor:
    """Truncated-normal fan-in init (``common.py:137``): fan_in =
    shape[0] for 2-D and up (for a 3-D expert weight (E, d, F) that is E,
    as in JAX), truncated_normal(-3, 3) in float32 times fan_in^-0.5 (or
    ``scale``), then cast."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _draw(key, shape, dtype, std,
                 lambda k, sh, start: prng.truncated_normal(
                     k, -3.0, 3.0, sh, start=start), chunk)


def embed_init(key: torch.Tensor, shape: Tuple[int, ...], dtype,
               chunk: int = INIT_CHUNK) -> torch.Tensor:
    """normal in float32 times 0.02, then cast (``common.py:145``)."""
    return _draw(key, tuple(int(s) for s in shape), dtype, 0.02,
                 prng.normal, chunk)


class KeyGen:
    """Sequential PRNG key dispenser: each call splits the carried key and
    hands out the second half, as JAX's ``KeyGen``."""

    def __init__(self, key: torch.Tensor):
        self._key = key

    def __call__(self) -> torch.Tensor:
        self._key, sub = prng.split(self._key)
        return sub


def stack_layer_params(layer_inits: Callable, n_layers: int,
                       keygen: KeyGen) -> Dict:
    """Initialize per-layer params and stack them along a leading axis.

    ``layer_inits(key)`` builds ONE layer.  JAX vmaps it over ``n_layers``
    keys from ``keygen``; threefry draws per key, so layer i's leaves are
    ``layer_inits(key_i)``'s.  The stacked leaves are allocated once and
    filled layer by layer: the peak is the stack plus one layer.
    """
    keys = [keygen() for _ in range(n_layers)]
    out = None
    for i, k in enumerate(keys):
        layer = layer_inits(k)
        if out is None:
            out = _map(lambda t: t.new_empty((n_layers,) + tuple(t.shape)),
                       layer)
        _fill(out, layer, i)
        del layer
    return out


def stacked(shapes, n: int):
    """Every shape of a nested dict with a leading ``n`` axis."""
    if isinstance(shapes, dict):
        return {k: stacked(v, n) for k, v in shapes.items()}
    return (n,) + tuple(shapes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fill(dst: Dict, src: Dict, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _fill(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """float32 mean of squares, rsqrt cast to x's dtype, (x * inv) * scale
    (``common.py:84-85``)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32 mean and (biased) variance, the normalised value cast back
    to x's dtype before ``* scale + bias`` (``common.py:88-94``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands cast to their promoted type first, as
    ``jnp.matmul`` promotes them (``torch.matmul`` raises on two types): a
    bfloat16 operand with a float32 one multiplies in float32.  Operands
    of one type pass through untouched."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with its operands cast to their promoted type
    first, as ``jnp.einsum`` promotes them (``torch.einsum`` raises on two
    types): in bfloat16 Mamba2's decays are float32 (``A`` is), and a
    float32 state meets bfloat16 expert weights in a moe trunk.  Operands
    of one type pass through untouched."""
    dt = functools.reduce(torch.promote_types, [o.dtype for o in ops])
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ w_gate) * (x @ w_up)) @ w_down, the products
    promoted (``matmul``)."""
    g = F.silu(matmul(x, w_gate))
    return matmul(g * matmul(x, w_up), w_down)


def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings. positions: (..., S) int.

    Returns two (..., S, dim/2) float32 tensors.
    """
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin broadcastable to (..., S, D/2).

    The head dim splits into two HALVES (not interleaved pairs).
    """
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """Transformer/DDPM sinusoidal embedding of integer timesteps, float32.

    t: (B,) integer tensor.  Returns (B, dim) float32 [cos | sin].
    """
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
