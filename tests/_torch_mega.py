"""Trunks and geometries of the megakernel tests past the slice's 64 tokens
and head dim 64 (``tests/test_torch_megastep.py``,
``tests/test_torch_megastep_rows.py``).

Each trunk is the JAX tests' diffusion-LM at 2 layers, latent 32, d_ff
128, built by the JAX ``init_params`` and carried across by
``interop.dlm_params_from_jax``: d_model 64 with head dim 16 (4 / 2
heads), 32 (2 / 1, GQA) and 64 (1 / 1), and d_model 128 with head dim
128 (1 / 1).  Geometries: 128 tokens (batch 2) and 256 (batch 1 for B3,
2 slots for B4).  States come from a numpy seed.  ``one_torch_thread``
runs a test module on one torch thread; ``jit_ref`` is JAX's reference
under one jit.
"""
import functools

import jax
import numpy as np

from repro import diffusion_lm as jdlm
from repro.kernels.megastep import MegaSpec as JMegaSpec
from repro.models.common import ArchConfig as JArch
from repro_torch import interop
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models.common import ArchConfig as TArch

from _torch_threads import one_torch_thread  # noqa: F401  (re-exported)

LATENT = 32
HEAD_DIMS = {16: (64, 4, 2), 32: (64, 2, 1), 64: (64, 1, 1),
             128: (128, 1, 1)}                    # d_model, heads, kv heads
SEQS = (128, 256)


@functools.lru_cache(maxsize=None)
def trunk(hd: int):
    """(JAX cfg, port cfg, JAX params, port params) at head dim ``hd``."""
    d_model, heads, kv_heads = HEAD_DIMS[hd]
    arch = dict(n_layers=2, d_model=d_model, n_heads=heads,
                n_kv_heads=kv_heads, d_ff=128, vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name=f"hd{hd}", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name=f"hd{hd}", family="dense",
                                             **arch), time_dim=32)
    assert tcfg.arch.hd() == hd and tcfg.latent_dim == LATENT
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def state(batch: int, seq: int, seed: int = 1) -> np.ndarray:
    """A (R, 256) float32 tile state of (batch, seq, LATENT)."""
    return np.random.RandomState(seed).randn(
        batch * seq * LATENT // 256, 256).astype(np.float32)


def jit_ref(ref_fn, jcfg, batch: int, seq: int, attn_impl: str, **kw):
    """JAX's ``ref_fn`` (``megastep_ref`` or ``megastep_rows_ref``, with
    ``kw`` such as ``clip``) over the spec of (jcfg, batch, seq, attn_impl),
    under one ``jax.jit``: called as f(x2, eps_weights, coefs, ts), it
    compiles the trunk once instead of dispatching its ops one by one."""
    def f(x2, w, coefs, ts):
        return ref_fn(x2, JMegaSpec(params=w, cfg=jcfg, batch=batch,
                                    seq_len=seq, attn_impl=attn_impl),
                      coefs, ts, **kw)
    return jax.jit(f)


def cast(tree, dtype):
    """A port parameter tree with its float leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
