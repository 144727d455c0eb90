"""The port's flash attention and chunked attention held against the JAX
package's, on the CPU.

Same seeded numpy inputs through both packages: the JAX side runs the Pallas
kernel in interpret mode (as ``tests/test_flash_attn_kernel.py`` does) or
its jnp ``chunked_attention``; the port runs its plain torch route, which is
what a CPU tensor takes. Tolerances are the reference's
(``tests/test_flash_attn_kernel.py:46,58``): 2e-4 in float32, 3e-2 in
bfloat16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.flash_attn import flash_attention_pallas
from repro.models import layers as jL
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain
from repro_torch.models import layers as tL

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype: str):
    """The same values as jnp and torch arrays of ``dtype``."""
    j = [jnp.asarray(a).astype(_JNP[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs]
    return j, t


def _close(t_out, j_out, dtype: str):
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
def test_flash_matches_pallas_interpret(causal, window, h, kh):
    b, sq, hd = 2, 256, 32
    (jq, jk, jv), (q, k, v) = _both(_normal(h * 7 + kh, (b, sq, h, hd), (b, sq, kh, hd), (b, sq, kh, hd)), "float32")
    exp = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, blk_q=64, blk_kv=64, interpret=True)
    before = tops.launch_counts["flash"]
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert tops.launch_counts["flash"] == before + 1
    _close(got, exp, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    b, sq, h, kh, hd = 1, 128, 2, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_normal(1, (b, sq, h, hd), (b, sq, kh, hd), (b, sq, kh, hd)), dtype)
    exp = flash_attention_pallas(jq, jk, jv, blk_q=64, blk_kv=64, interpret=True)
    got = flash_attention_cuda(q, k, v)  # a CPU tensor takes the plain route
    assert got.dtype == _TORCH[dtype] and got.shape == q.shape
    _close(got, exp, dtype)


def test_flash_cross_block_shapes():
    """Sq != Skv (a suffix against a longer cache), not causal."""
    b, sq, skv, h, kh, hd = 1, 64, 256, 2, 1, 32
    (jq, jk, jv), (q, k, v) = _both(_normal(2, (b, sq, h, hd), (b, skv, kh, hd), (b, skv, kh, hd)), "float32")
    exp = flash_attention_pallas(jq, jk, jv, causal=False, blk_q=32, blk_kv=64, interpret=True)
    _close(flash_attention_plain(q, k, v, causal=False), exp, "float32")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0)])
def test_flash_ops_route_matches_jax_ops(causal, window):
    """``ops.flash_attention`` of both packages off the TPU, at a length the
    JAX route splits into several 1024-row kv chunks."""
    b, s, h, kh, hd = 1, 2048, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _both(_normal(3, (b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)), "float32")
    exp = jops.flash_attention(jq, jk, jv, causal=causal, window=window, use_pallas=False)
    _close(tops.flash_attention(q, k, v, causal=causal, window=window), exp, "float32")


def _dense_ref(q, k, v, causal, window, offset, scale):
    """float64 softmax attention on (B, S, K, R, hd) grouped queries; a row
    with no visible key gives 0 (as the kernels' ``acc / max(l, 1e-30)``)."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqkrh,bskh->bkrqs", q, k) * scale
    qi = np.arange(q.shape[1])[:, None] + offset
    ki = np.arange(k.shape[1])[None, :]
    ok = np.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        ok &= ki <= qi
    if window:
        ok &= ki > qi - window
    s = np.where(ok, s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    p = np.where(ok, np.exp(s - np.where(np.isfinite(m), m, 0)), 0.0)
    w = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    return np.moveaxis(np.einsum("bkrqs,bskh->bkrqh", w, v), 3, 1)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 8), (16, 4), (32, 32)])
@pytest.mark.parametrize("mask_offset", [0, 8])
def test_chunked_matches_jax(causal, window, q_chunk, kv_chunk, mask_offset):
    b, sq, skv, kh, rep, hd = 2, 32, 64, 2, 2, 16
    jin, tin = _both(_normal(4, (b, sq, kh, rep, hd), (b, skv, kh, hd), (b, skv, kh, hd)), "float32")
    kw = dict(causal=causal, window=window, mask_offset=mask_offset, q_chunk=q_chunk, kv_chunk=kv_chunk, scale=0.25)
    exp = jL.chunked_attention(*jin, **kw)
    got = tL.chunked_attention(*tin, **kw)
    _close(got, exp, "float32")
    np.testing.assert_allclose(got.numpy(), _dense_ref(*tin, causal, window, mask_offset, 0.25), rtol=2e-5, atol=2e-5)


def test_chunked_v_head_dim_differs_from_qk():
    """The MLA case: v head dim != qk head dim."""
    b, s, kh, rep, hd, vd = 1, 16, 3, 1, 24, 8
    jin, tin = _both(_normal(5, (b, s, kh, rep, hd), (b, s, kh, hd), (b, s, kh, vd)), "float32")
    kw = dict(causal=True, window=0, mask_offset=0, q_chunk=8, kv_chunk=8, scale=0.2)
    got = tL.chunked_attention(*tin, **kw)
    assert got.shape == (b, s, kh, rep, vd)
    _close(got, jL.chunked_attention(*jin, **kw), "float32")


@pytest.mark.parametrize("sq,skv,q_chunk,kv_chunk", [(24, 24, 32, 64), (40, 56, 8, 8), (1000, 1000, 2048, 1024)])
def test_chunked_ragged_lengths_match_jax(sq, skv, q_chunk, kv_chunk):
    """Lengths that are no power of two, where the JAX version is defined
    (each chunk divides its length, or covers it)."""
    jin, tin = _both(_normal(6, (1, sq, 2, 2, 32), (1, skv, 2, 32), (1, skv, 2, 32)), "float32")
    kw = dict(causal=True, window=0, mask_offset=skv - sq, q_chunk=q_chunk, kv_chunk=kv_chunk, scale=1 / math.sqrt(32))
    _close(tL.chunked_attention(*tin, **kw), jL.chunked_attention(*jin, **kw), "float32")


@pytest.mark.parametrize("sq,skv,causal,window,offset", [
    (37, 37, True, 0, 0), (37, 53, True, 5, 16), (70, 9, False, 0, 0), (4097, 4097, True, 64, 0), (300, 100, True, 64, 0),
])
def test_chunked_takes_lengths_the_chunks_do_not_divide(sq, skv, causal, window, offset):
    """The port's extension: the last chunk of each loop is shorter. Held
    against a float64 softmax (fully masked rows give 0)."""
    _, tin = _both(_normal(7, (1, sq, 2, 2, 32), (1, skv, 2, 32), (1, skv, 2, 32)), "float32")
    got = tL.chunked_attention(*tin, causal=causal, window=window, mask_offset=offset,
                               q_chunk=16, kv_chunk=1024 if sq > 1000 else 16, scale=0.3)
    np.testing.assert_allclose(got.numpy(), _dense_ref(*tin, causal, window, offset, 0.3), rtol=2e-5, atol=2e-5)
