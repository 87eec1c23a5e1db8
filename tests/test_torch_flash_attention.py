"""B5 flash attention: the port's ``mha_flash`` / ``gqa_flash`` (plain
version on the CPU) against the JAX package's Pallas kernel (interpret
mode) and the model's grouped attention, on the same numpy inputs.

Tolerances as ``test_kernels.py:17`` holds the JAX kernel: float32 2e-5,
bfloat16 2e-2 (absolute and relative); float16 1e-3, about one float16
ulp (both compute in float32 and round once at the store).  The online-softmax recurrence runs
over the same KV blocks on both sides; the sums inside the products are
taken in another order.  The CUDA kernel's own tile arithmetic (its q and
KV tiles, 3xTF32 products) is emulated by ``ref.flash_attention_tiles_ref``
and held to the JAX kernel at the same float32 tolerance.

The kernel's whole domain (any S the block check admits, head dims 1 to
256 at the widths of ``ref.HEAD_WIDTHS``, zero-padded, past 256 the XL
kernel's chunked depth, the last KV and q tiles ragged): pairs of head dim
and S that together take every head dim of {32, 80, 112, 33, 192, 256,
320, 512} and every S of {1, 15, 37, 64, 100, 128}, S 160 with blocks (32,
32), and JAX's own sweep shape (2, 1, 512, 32) and GQA shape (2, 128, 8,
32); JAX's interpret grids stay at 25 programs per BH or fewer.  q, k and
v of different types: JAX casts each to float32 and the output to q's
type, and so does the port (tolerance of q's type).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.kernels import gqa_flash as j_gqa_flash
from repro.kernels import mha_flash as j_mha_flash
from repro.kernels.flash_attention.kernel import \
    flash_attention as j_flash_attention
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2),
       "f16": dict(atol=1e-3, rtol=1e-3)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16),
      "f16": (jnp.float16, torch.float16)}


def _qkv(shapes, dtype, seed=0):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*s).astype(np.float32) for s in shapes]
    jdt, tdt = DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("B,H,S,D", [(2, 2, 128, 64), (1, 2, 256, 32),
                                     (1, 2, 128, 128)], ids=str)
def test_mha_flash_matches_jax_kernel(B, H, S, D, causal, dtype):
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(B, H, S, D)] * 3, dtype)
    _close(tops.mha_flash(tq, tk_, tv, causal=causal),
           j_mha_flash(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("kv_split", [1, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("B,H,S,D", [(2, 2, 128, 64), (1, 2, 128, 128)],
                         ids=str)
def test_kernel_tile_arithmetic_matches_jax_kernel(B, H, S, D, causal,
                                                   kv_split):
    """The CUDA kernel's float32 arithmetic (64-row q tiles, KV tiles of
    64 rows at D 64 and 32 at D 128 in ascending order, 3xTF32 products;
    with kv_split 4, 16-row q tiles whose KV columns four recurrences
    share and merge) against the Pallas kernel in interpret mode."""
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(B * H, S, D)] * 3, "f32", seed=4)
    _close(tref.flash_attention_tiles_ref(tq, tk_, tv, causal=causal,
                                          kv_split=kv_split),
           j_flash_attention(jq, jk, jv, causal=causal), "f32")


@pytest.mark.parametrize("block", [(64, 64), (128, 64)], ids=str)
def test_mha_flash_blocks_match_jax_kernel(block):
    bq, bk = block
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(2, 2, 256, 64)] * 3, "f32", seed=1)
    _close(tops.mha_flash(tq, tk_, tv, causal=True, block_q=bq,
                          block_k=bk),
           j_mha_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk),
           "f32")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gqa_flash_matches_jax_and_model_attention(causal):
    """8 query heads over 2 KV heads: q head h reads kv head h // 4."""
    shapes = [(2, 128, 8, 32), (2, 128, 2, 32), (2, 128, 2, 32)]
    (jq, jk, jv), (tq, tk_, tv) = _qkv(shapes, "f32", seed=2)
    got = tops.gqa_flash(tq, tk_, tv, causal=causal)
    _close(got, j_gqa_flash(jq, jk, jv, causal=causal), "f32")
    jmask = (jcommon.causal_mask(128) if causal
             else jnp.zeros((128, 128), jnp.float32))
    want = jattn._grouped_attention(jq, jk, jv, jnp.maximum(jmask, -1e30))
    _close(got, want, "f32")
    tmask = (tcommon.causal_mask(128) if causal
             else torch.zeros(128, 128))
    _close(tattn._grouped_attention(tq, tk_, tv,
                                    torch.clamp(tmask, min=-1e30)),
           want, "f32")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_recurrence_matches_attention_ref(causal):
    """The port's own plain pieces agree: the streaming recurrence (with a
    ragged tail block) and the plain softmax attention."""
    _, (tq, tk_, tv) = _qkv([(1, 3, 96, 64)] * 3, "f32", seed=3)
    want = tref.attention_ref(tq, tk_, tv, causal=causal)
    got = tref.streaming_attention_body(tq, tk_, tv, scale=0.125,
                                        causal=causal, block_k=64)
    torch.testing.assert_close(got, want, **TOL["f32"])


def test_flash_attention_checks_blocks_and_counts_nothing_on_cpu():
    q = torch.zeros(2, 192, 64)
    with pytest.raises(ValueError, match="multiple"):
        tk.flash_attention(q, q, q, block_q=128)
    n0 = tk.flash_attention.launches
    tk.flash_attention(q, q, q, block_q=64, block_k=64)
    assert tk.flash_attention.launches == n0


# (D, S): every head dim and every S of the domain's test set at least once
DOMAIN = [(32, 1), (80, 15), (112, 37), (33, 100), (192, 128), (256, 15),
          (256, 100), (320, 37), (512, 64)]


def _tiles_vs_jax(tq, tk_, tv, want, causal, splits=(1, 2, 4)):
    """The kernel's float32 tile arithmetic at every KV split against
    JAX's output ``want`` (B, H, S, D)."""
    B, H, S, D = tq.shape
    flat = [t.reshape(B * H, S, D) for t in (tq, tk_, tv)]
    for kv_split in splits:
        got = tref.flash_attention_tiles_ref(*flat, causal=causal,
                                             kv_split=kv_split)
        _close(got.reshape(B, H, S, D), want, "f32")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D,S", DOMAIN, ids=[f"D{d}-S{s}" for d, s in DOMAIN])
def test_domain_matches_jax_kernel(D, S, causal):
    """Padded head widths and ragged S: the plain version and the tile
    arithmetic (KV split 1, 2 and 4) against JAX's ``mha_flash``."""
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(1, 2, S, D)] * 3, "f32",
                                       seed=D + S)
    want = j_mha_flash(jq, jk, jv, causal=causal)
    _close(tops.mha_flash(tq, tk_, tv, causal=causal), want, "f32")
    # past 256 the kernel never splits the KV columns
    _tiles_vs_jax(tq, tk_, tv, want, causal,
                  splits=(1, 2, 4) if D <= tref.MAX_HEAD_DIM else (1,))


# q, k, v types (q's is the output's): a 16-bit q over float32 k and v,
# float32 q over 16-bit operands, and three-type mixes
MIXES = [("bf16", "f32", "f32"), ("f16", "f32", "f32"),
         ("f32", "bf16", "f16"), ("bf16", "f16", "f32"),
         ("f16", "bf16", "bf16"), ("f32", "f32", "bf16")]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("qt,kt,vt", MIXES, ids="-".join)
def test_mixed_qkv_types_match_jax_kernel(qt, kt, vt, causal):
    """JAX's flash_attention takes q, k and v of different types: every
    operand in float32, the output in q's type.  The port's plain version
    does the same (and the CUDA wrapper widens to the float32 library)."""
    rs = np.random.RandomState(len(qt + kt + vt))
    arrs = [rs.randn(2, 64, 64).astype(np.float32) for _ in range(3)]
    j = [jnp.asarray(a, DT[t][0]) for a, t in zip(arrs, (qt, kt, vt))]
    t = [torch.from_numpy(a).to(DT[u][1]) for a, u in zip(arrs, (qt, kt, vt))]
    want = j_flash_attention(*j, causal=causal)
    got = tk.flash_attention(*t, causal=causal)
    assert got.dtype == DT[qt][1] and want.dtype == DT[qt][0]
    _close(got, want, qt)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D,S", [(80, 37), (33, 100)], ids=str)
def test_domain_bf16_matches_jax_kernel(D, S, causal):
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(1, 2, S, D)] * 3, "bf16",
                                       seed=D * S)
    _close(tops.mha_flash(tq, tk_, tv, causal=causal),
           j_mha_flash(jq, jk, jv, causal=causal), "bf16")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_seq_160_blocks_32_matches_jax_kernel(causal):
    """S 160 is no multiple of the default blocks' 128: JAX and the port
    both refuse it, and both take it with blocks (32, 32)."""
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(1, 2, 160, 80)] * 3, "f32",
                                       seed=160)
    with pytest.raises(AssertionError):
        j_mha_flash(jq, jk, jv, causal=causal)
    with pytest.raises(ValueError, match="multiple"):
        tops.mha_flash(tq, tk_, tv, causal=causal)
    want = j_mha_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32)
    _close(tops.mha_flash(tq, tk_, tv, causal=causal, block_q=32,
                          block_k=32), want, "f32")
    _tiles_vs_jax(tq, tk_, tv, want, causal, splits=(1, 4))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_jax_sweep_shape_matches_jax_kernel(causal):
    """``tests/test_kernels.py``'s (2, 1, 512, 32), head dim 32."""
    (jq, jk, jv), (tq, tk_, tv) = _qkv([(2, 1, 512, 32)] * 3, "f32",
                                       seed=512)
    want = j_mha_flash(jq, jk, jv, causal=causal)
    _close(tops.mha_flash(tq, tk_, tv, causal=causal), want, "f32")
    _tiles_vs_jax(tq, tk_, tv, want, causal, splits=(1, 4))


def test_gqa_shape_tile_arithmetic_matches_jax_kernel():
    """JAX's GQA shape (2, 128, 8, 32) over 2 KV heads: the kernel's tile
    arithmetic on the layout ``gqa_flash`` hands it."""
    shapes = [(2, 128, 8, 32), (2, 128, 2, 32), (2, 128, 2, 32)]
    (jq, jk, jv), (tq, tk_, tv) = _qkv(shapes, "f32", seed=8)
    want = j_gqa_flash(jq, jk, jv, causal=True)
    kr, vr = (torch.repeat_interleave(t, 4, dim=2) for t in (tk_, tv))
    _tiles_vs_jax(tq.transpose(1, 2), kr.transpose(1, 2),
                  vr.transpose(1, 2), np.asarray(want).transpose(0, 2, 1, 3),
                  True, splits=(1, 4))


def test_kernel_plan_model_covers_the_domain():
    """The widths, KV tiles and splits the tile arithmetic assumes, as
    ``csrc/flash_launch.cuh`` launches them."""
    assert [tref.kernel_head_width(d) for d in (1, 32, 33, 80, 112, 128,
                                                129, 192, 255, 256)] == \
        [32, 32, 64, 96, 128, 128, 160, 192, 256, 256]
    assert all(0 <= tref.kernel_head_width(d) - d < 32
               for d in range(1, 257))
    assert [tref.kernel_kv_tile(d, torch.float32) for d in (33, 64, 65)] \
        == [64, 64, 32]
    assert tref.kernel_kv_tile(256, torch.bfloat16) == 64
    assert tref.kernel_kv_split(2, 100, 4) == 1     # 2 x 2 ragged q tiles
    assert tref.kernel_kv_split(2, 37, 4) == 2
    assert tref.kernel_kv_split(1, 1, 132) == 4
    # past 256: the XL kernel's depth in chunks of 64, output slices of
    # 256, no KV split, the KV tiles of width 256
    assert [tref.kernel_head_width(d) for d in (257, 288, 320, 512, 1000)] \
        == [320, 320, 320, 512, 1024]
    assert [tref.kernel_slices(d) for d in (256, 257, 512, 513, 1024)] == \
        [1, 2, 2, 3, 4]
    assert tref.kernel_kv_split(1, 1, 132, d=512) == 1
    assert tref.kernel_kv_tile(512, torch.float32) == 32
    assert tref.kernel_kv_tile(512, torch.float16) == 64
    with pytest.raises(ValueError, match="from 1"):
        tref.kernel_head_width(0)


def test_wrapper_refuses_past_the_domain_on_the_card():
    """Meta tensors stand for the card: float64 raises with its reason
    before any launch, and head dim 257 (the XL libraries), float16 and q,
    k, v of three types pass to the device check; the CPU takes all of
    them (plain)."""
    q = torch.zeros(2, 64, 257, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.flash_attention(q.half(), q.bfloat16(), q)
    w = torch.zeros(2, 64, 64, device="meta", dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        tk.flash_attention(w, w, w)
    with pytest.raises(TypeError, match="float64"):
        tk.flash_attention(q, q, torch.zeros(2, 64, 257, device="meta",
                                             dtype=torch.float64))
    h = torch.zeros(2, 64, 64, device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.flash_attention(h, h, h)
    assert tk.library_name(torch.float16, 64) == "flash_attention_f16"
    assert tk.library_name(torch.float16, 256) == "flash_attention_f16_wide"
    assert tk.library_name(torch.float16, 320) == "flash_attention_f16_xl"
    assert tk.library_name(torch.float32, 512) == "flash_attention_xl"
    x = torch.randn(1, 16, 257)
    torch.testing.assert_close(tk.flash_attention(x, x, x),
                               tref.flash_attention_ref(x, x, x))
