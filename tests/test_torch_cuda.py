"""The port's CUDA kernels held against their plain torch twins on the card.

Every test here is marked ``cuda`` and skips where torch sees no GPU. Run
them on a machine with an H100 (which needs no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The dedup kernels' outputs are integers, so their tolerance is 0. The
flash-attention kernel is held to chip_smoke.py's limit (``FLASH_RTOL``,
``flash_err_ratio``): per element, |kernel - plain| <= rtol * (|plain| +
the RMS of plain's row over the head dim), rtol 2e-4 in float32 and 1.6e-2
in bfloat16, with TF32 off so float32 products run in full float32. The
limit scales with the data, so it still bites on the late rows of long
causal inputs, whose elements are small. Its backward kernel is held to
its plain twin by ``chip_smoke.FlashBwdCheck`` (the same form,
``FLASH_BWD_RTOL``, plus ``FLASH_BWD_ATOL`` of the tensor's RMS for rows
whose exact gradient is 0), and
``mha(impl="chunked")`` and every arch's train step through it to the
CPU's route.
"""

import contextlib
import copy
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.core.chunking import cdc_mask, chunk_cdc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cdc import (
    cdc_cut_masks_cuda,
    cdc_cut_positions_cuda,
    cdc_hashes_cuda,
    gear_values,
)
from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda
from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain

# (n, target, min, max) of the 8-spec device-cut sweep, plus one stream of
# the checkpoint's own geometry (512K target, 256K..1M chunks).
SWEEP = [
    (3000, 256, 64, 1024),
    (4096, 64, 1, 97),
    (100, 1024, 60, 4096),
    (1, 16, 1, 8),
    (777, 32, 31, 33),
    (2048, 128, 100, 101),
    (1500, 64, 50, 50),
    (5000, 512, 0, 0),
    (3 << 20, 512 * 1024, 256 * 1024, 1 << 20),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bytes(n: int, seed: int, device) -> torch.Tensor:
    data = np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)
    return torch.from_numpy(data).to(device)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 128), (2, 129), (300, 700), (257, 513), (64, 262272)])
def test_fingerprint_kernel_matches_twin(cuda, shape):
    rows = np.random.default_rng(shape[1]).integers(0, 2**32, size=shape, dtype=np.uint32)
    x = torch.from_numpy(rows).to(cuda)
    before = fingerprint_chunks_cuda.launches
    got = fingerprint_chunks_cuda(x)
    assert fingerprint_chunks_cuda.launches == before + 1
    assert _same(got, ref.fingerprint_chunks(x))


# A stream longer than 2^31 bytes (2.2 GB in, 8.9 GB of hashes out).
LONG_STREAM = (1 << 31) + (1 << 26) + 7


def hash_windows_match(data: torch.Tensor, got: torch.Tensor, spans) -> bool:
    """``got``, the kernel's hashes of ``data``, equals the plain hashes on
    each [lo, hi) of ``spans``: a window depends only on the 32 bytes up to
    its position, so the plain hash of data[lo - 32 : hi] gives them."""
    for lo, hi in spans:
        plain = ref.cdc_hashes(gear_values(data[max(lo - 32, 0) : hi]))
        if not _same(got[lo:hi], plain[min(lo, 32) :]):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1024, 1025, 5000, 8191, 8192, 8193, 8192 * 37 + 5,
                               1 << 20, 1 << 27, LONG_STREAM])
def test_window_hash_kernel_matches_twin(cuda, n):
    """Exact against the plain hashes: tails, tile edges, more tiles than the
    card holds blocks (2^27), a view at byte offset 1 (the wrapper's clone
    path) and, above 2^31 bytes, windows around 2^31 and at the end."""
    if n == LONG_STREAM:
        gen = torch.Generator(device=cuda).manual_seed(n)
        data = torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda, generator=gen)
        before = cdc_hashes_cuda.launches
        got = cdc_hashes_cuda(data)
        assert cdc_hashes_cuda.launches == before + 1
        assert got.shape == (n,)
        assert hash_windows_match(data, got, [((1 << 31) - 64, (1 << 31) + 64), (n - 64, n), (0, 64)])
        return
    data = _bytes(n + 1, n, cuda)
    for view in (data[:n], data[1:]):
        before = cdc_hashes_cuda.launches
        got = cdc_hashes_cuda(view)
        assert cdc_hashes_cuda.launches == before + 1
        assert _same(got, ref.cdc_hashes(gear_values(view)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,target,mn,mx", SWEEP)
def test_cut_mask_kernel_matches_twin(cuda, n, target, mn, mx):
    spec = ChunkingSpec("cdc", target, mn, mx).normalized()
    kw = dict(mask=cdc_mask(spec.chunk_size), min_size=spec.min_size, max_size=spec.max_size)
    data = _bytes(n, n * 31 + target, cuda)
    # a wave of two streams, the second one a prefix of the first
    streams = [data, data[: max(1, n // 3)].clone()]
    before = cdc_cut_masks_cuda.launches
    got = cdc_cut_masks_cuda(streams, **kw)
    assert cdc_cut_masks_cuda.launches == before + 1
    exp = cdc_cut_masks_cuda([s.cpu() for s in streams], **kw)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
def test_cut_mask_kernel_reads_unaligned_streams(cuda):
    data = _bytes(100_000, 5, cuda)
    kw = dict(mask=cdc_mask(2048), min_size=512, max_size=8192)
    got = cdc_cut_masks_cuda([data[3:]], **kw)[0]
    exp = cdc_cut_masks_cuda([data[3:].cpu()], **kw)[0]
    assert torch.equal(got.cpu(), exp)


def _positions_and_routes(streams, **kw):
    """The positions kernel's result on a CUDA wave, its twin's on the same
    bytes, and the streams per route of the one launch it made."""
    before = cdc_cut_positions_cuda.launches
    routes = dict(cdc_cut_positions_cuda.routes)
    got = cdc_cut_positions_cuda(streams, **kw)
    assert cdc_cut_positions_cuda.launches == before + 1
    routes = {k: v - routes[k] for k, v in cdc_cut_positions_cuda.routes.items()}
    exp = cdc_cut_positions_cuda([s.cpu() for s in streams], **kw)
    for (g, gn, gk), (e, en, ek) in zip(got, exp):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert (gn, gk) == (en, ek)
        assert torch.equal(g.cpu(), e)
    return got, routes


@pytest.mark.cuda
@pytest.mark.parametrize("n,target,mn,mx", SWEEP)
def test_cut_positions_kernel_matches_twin(cuda, n, target, mn, mx):
    spec = ChunkingSpec("cdc", target, mn, mx).normalized()
    kw = dict(mask=cdc_mask(spec.chunk_size), min_size=spec.min_size, max_size=spec.max_size)
    data = _bytes(n, n * 31 + target, cuda)
    _, routes = _positions_and_routes([data, data[: max(1, n // 3)].clone()], **kw)
    assert sum(routes.values()) == 2


@pytest.mark.cuda
def test_cut_positions_list_route_at_the_checkpoint_spec(cuda):
    """The checkpoint's 512 KiB target gives ~1 candidate per 512 KiB: every
    stream's candidates fit the list, and each one is walked there."""
    kw = dict(mask=cdc_mask(512 * 1024), min_size=256 * 1024, max_size=1 << 20)
    streams = [_bytes(n, n, cuda) for n in (24 << 20, 5 << 20, 300_001)]
    got, routes = _positions_and_routes(streams, **kw)
    assert routes == {"list": 3, "bitmap": 0}
    assert got[0][1] > 20


@pytest.mark.cuda
@pytest.mark.parametrize("n,kw", [
    (1 << 20, dict(mask=cdc_mask(16), min_size=8, max_size=64)),  # ~65 K candidates
    (1 << 16, dict(mask=0, min_size=64, max_size=256)),  # every position a candidate
])
def test_cut_positions_bitmap_route_when_the_list_overflows(cuda, n, kw):
    """A stream with more candidates than the list holds walks the bitmap;
    the 5,000-byte stream beside it (at most 5,000 candidates) the list."""
    got, routes = _positions_and_routes([_bytes(n, 7, cuda), _bytes(5000, 8, cuda)], **kw)
    assert routes == {"list": 1, "bitmap": 1}
    assert got[0][1] > n // kw["max_size"]


@pytest.mark.cuda
def test_cut_positions_stream_shorter_than_min_size(cuda):
    kw = dict(mask=cdc_mask(2048), min_size=1024, max_size=4096)
    [(pos, n_cuts, n_chunks)], _ = _positions_and_routes([_bytes(100, 3, cuda)], **kw)
    assert (n_cuts, n_chunks) == (0, 1)
    assert pos.tolist() == [100]


@pytest.mark.cuda
def test_cut_positions_kernel_reads_unaligned_streams(cuda):
    data = _bytes(100_000, 5, cuda)
    kw = dict(mask=cdc_mask(2048), min_size=512, max_size=8192)
    _positions_and_routes([data[3:], data[1:77_777]], **kw)


@pytest.mark.cuda
def test_fused_wave_matches_cpu_route(cuda):
    spec = ChunkingSpec("cdc", 8 * 1024, 4 * 1024, 16 * 1024)
    kw = dict(mask=cdc_mask(spec.chunk_size), min_size=spec.min_size, max_size=spec.max_size)
    streams = [_bytes(n, n, cuda) for n in (131072, 65536, 1, 16384)]
    got = ops.cdc_cut_and_fingerprint_many(streams, **kw)
    exp = ops.cdc_cut_and_fingerprint_many([s.cpu() for s in streams], **kw)
    for (gc, gn, gf, gk), (ec, en, ef, ek) in zip(got, exp):
        assert (gn, gk) == (en, ek)
        assert torch.equal(gc.cpu(), ec)
        assert torch.equal(gf.cpu().view(torch.int32), ef.view(torch.int32))


@pytest.mark.cuda
def test_chunk_cdc_backends_on_card(cuda):
    data = _bytes(40 * 1024, 17, "cpu").numpy().tobytes()
    spec = ChunkingSpec("cdc", 1024)
    host = list(chunk_cdc(data, spec))
    assert list(chunk_cdc(data, spec, backend="kernel")) == host
    assert list(chunk_cdc(data, spec, backend="device")) == host


@pytest.mark.cuda
def test_checkpointer_on_card(cuda):
    from repro_torch.checkpoint import DedupCheckpointer

    cluster = DedupCluster.create(3, chunking=ChunkingSpec("fixed", 16 * 1024))
    ckpt = DedupCheckpointer(cluster)
    assert ckpt.device.type == "cuda"
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(300_000, generator=g, device=cuda), "step": 3}
    ckpt.save("s1", tree)
    ckpt.save("s2", tree)
    assert ckpt.stats["leaves_ref_only"] == 1
    assert (ckpt.stats["cdc_launches"], ckpt.stats["fp_launches"]) == (2, 2)
    back = ckpt.restore("s2", like=tree)
    assert torch.equal(back["w"], tree["w"])


def _qkv(shape_q, shape_kv, dtype, seed, device, shape_v=None):
    rng = np.random.default_rng(seed)
    shapes = (shape_q, shape_kv, shape_kv if shape_v is None else shape_v)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)]


_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _flash_close(q, k, v, **kw):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, **kw)
    assert flash_attention_cuda.launches == before + 1
    exp = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == (*q.shape[:-1], v.shape[-1])
    rtol = chip_smoke.FLASH_RTOL["bfloat16" if q.dtype == torch.bfloat16 else "float32"]
    n_bad = int((~(chip_smoke.flash_err_ratio(got, exp) <= rtol)).sum())
    assert n_bad == 0, f"{n_bad} of {exp.numel()} elements beyond the limit"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
def test_flash_kernel_grid_matches_plain(cuda, dtype, causal, window, h, kh):
    q, k, v = _qkv((2, 256, h, 32), (2, 256, kh, 32), dtype, h * 10 + kh, cuda)
    _flash_close(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (1000, 1000, True, 0), (4097, 4097, True, 0), (64, 256, False, 0),
    (300, 100, True, 0), (300, 100, True, 64), (1, 77, False, 0), (129, 129, True, 1),
])
def test_flash_kernel_ragged_and_rectangular(cuda, dtype, hd, sq, skv, causal, window):
    q, k, v = _qkv((1, sq, 4, hd), (1, skv, 2, hd), dtype, sq + skv + hd, cuda)
    _flash_close(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_qwen_heads_and_strided_views(cuda, dtype):
    # (40, 8) heads at hd 128, as Qwen2.5-32B; k and v are views into one
    # (B, S, 2, K, hd) buffer, so their batch and sequence strides are not
    # those of a contiguous tensor.
    q, _, _ = _qkv((1, 700, 40, 128), (1, 1, 1, 1), dtype, 5, cuda)
    kv = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 700, 2, 8, 128)).astype(np.float32))
    kv = kv.to(device=cuda, dtype=dtype)
    _flash_close(q, kv[:, :, 0], kv[:, :, 1], causal=True, window=0)


# bf16 tiling: the kernel's blocks hold 128 query rows (two consumers of 64)
# and its K/V ring tiles 128 rows (64 at hd 256). Lengths on either side of
# a tile, windows that cut through one, Sq > Skv, and whole-tile windows.
@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (127, 127, True, 0), (128, 128, True, 0), (129, 129, True, 0), (255, 255, True, 0), (257, 257, True, 0),
    (129, 129, False, 0), (257, 257, False, 0), (300, 300, True, 100), (400, 400, True, 129),
    (257, 129, True, 0), (384, 255, False, 0), (300, 127, True, 100), (640, 640, True, 128),
])
def test_flash_kernel_bf16_tiles(cuda, hd, sq, skv, causal, window):
    q, k, v = _qkv((1, sq, 4, hd), (1, skv, 2, hd), torch.bfloat16, 3 * sq + skv + hd, cuda)
    _flash_close(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("window", [0, 129])
def test_flash_kernel_bf16_batch2_qwen_heads(cuda, hd, window):
    q, k, v = _qkv((2, 257, 40, hd), (2, 257, 8, hd), torch.bfloat16, hd + window, cuda)
    _flash_close(q, k, v, causal=True, window=window)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 48), (1, 16, 2, 48), torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv((1, 16, 2, 32), (1, 16, 2, 32), torch.float16, 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_cuda(q, k, v)
    # bf16 goes through TMA: a K view 8 bytes into its buffer, and one whose
    # sequence stride (72 bytes) is no multiple of 16, both raise.
    q, _, _ = _qkv((1, 16, 2, 32), (1, 1, 1, 1), torch.bfloat16, 0, cuda)
    buf = torch.zeros((1, 16, 2, 40), dtype=torch.bfloat16, device=cuda)
    k = buf[..., 4:36]
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_cuda(q, k, k.clone())
    k = torch.zeros((1, 16, 2, 36), dtype=torch.bfloat16, device=cuda)[..., :32]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention_cuda(q, k, k.contiguous())


# MLA's head dims (MiniCPM3-4B: q and k 64 + 32 rope, v 64), every query
# head its own kv head as mla_prefill expands them; lengths on either side
# of the 128-row tiles, ragged Sq and Skv, windows and Sq > Skv.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (127, 127, True, 0), (129, 129, True, 0), (257, 257, True, 0), (1000, 1000, True, 0), (4097, 4097, True, 0),
    (300, 100, True, 0), (257, 129, True, 0), (384, 255, False, 0), (1, 77, False, 0), (400, 400, True, 129),
])
def test_flash_kernel_mla_head_dims_match_plain(cuda, dtype, sq, skv, causal, window):
    q, k, v = _qkv((1, sq, 8, 96), (1, skv, 8, 96), dtype, sq + 2 * skv, cuda, shape_v=(1, skv, 8, 64))
    _flash_close(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
def test_flash_kernel_mla_batch2_and_grouped_heads(cuda):
    q, k, v = _qkv((2, 257, 40, 96), (2, 257, 8, 96), torch.bfloat16, 7, cuda, shape_v=(2, 257, 8, 64))
    _flash_close(q, k, v, causal=True, window=0)


@pytest.mark.cuda
def test_flash_kernel_rejects_head_dim_pairs_it_was_not_built_for(cuda):
    """(96, 96), (64, 96), (128, 64) and (96, 32) raise, as does a bf16
    (96, 64) v that TMA cannot read (an 8-byte offset); no launch is made."""
    before = flash_attention_cuda.launches
    for dqk, dv in ((96, 96), (64, 96), (128, 64), (96, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv((1, 16, 2, dqk), (1, 16, 2, dqk), dtype, 0, cuda, shape_v=(1, 16, 2, dv))
            with pytest.raises(ValueError, match="head dims"):
                flash_attention_cuda(q, k, v)
    q, k, _ = _qkv((1, 16, 2, 96), (1, 16, 2, 96), torch.bfloat16, 0, cuda)
    v = torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16, device=cuda)[..., 4:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before


def _rel_rms(got: torch.Tensor, exp: torch.Tensor) -> float:
    return float((got - exp).square().mean().sqrt() / exp.square().mean().sqrt())


def _float64_prefill(params, cfg, toks) -> tuple:
    """A reduced dense decoder's prefill in float64 on the host from the
    port's parameters (float64 copies): per layer the rotated k it caches,
    and the last position's logits."""
    def p64(t):
        return t.detach().cpu().double()

    def norm(scale, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps) * p64(scale)

    def lin(d, x):
        y = x @ p64(d.w)
        return y if d.b is None else y + p64(d.b)

    hd, h, kh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    s = toks.shape[1]
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = torch.arange(s, dtype=torch.float64)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    def rope(x):
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    x = p64(params.embed.table)[torch.as_tensor(toks).long()]
    ks, causal = [], torch.ones(s, s, dtype=torch.bool).triu(1)
    for blk in params.blocks:
        a = norm(blk.norm1.scale, x)
        q = rope(lin(blk.attn.wq, a).unflatten(-1, (h, hd)))
        k = rope(lin(blk.attn.wk, a).unflatten(-1, (kh, hd)))
        v = lin(blk.attn.wv, a).unflatten(-1, (kh, hd))
        ks.append(k)
        sc = torch.einsum("bqhd,bshd->bhqs", q, k.repeat_interleave(h // kh, 2)) / hd ** 0.5
        w = torch.softmax(sc.masked_fill(causal, -float("inf")), -1)
        o = torch.einsum("bhqs,bshd->bqhd", w, v.repeat_interleave(h // kh, 2))
        x = x + lin(blk.attn.wo, o.flatten(2))
        m = norm(blk.norm2.scale, x)
        x = x + lin(blk.ffn.down, torch.nn.functional.silu(lin(blk.ffn.gate, m)) * lin(blk.ffn.up, m))
    return ks, norm(params.final_norm.scale, x)[:, -1:] @ p64(params.lm_head.w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_prefill_on_card_launches_the_kernel_per_layer(cuda, dtype):
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), attn_impl="chunked", n_layers=3, param_dtype=dtype)
    m = build_model(cfg)
    # the witness: the same weights on the card through attn_impl="dense"
    # (cuBLAS products and a torch softmax, no kernel)
    m_dense = build_model(dataclasses.replace(cfg, attn_impl="dense"))
    assert m.device.type == "cuda"
    params = m.init(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32)
    nxt = torch.from_numpy(toks[:, :1].copy())
    before = flash_attention_cuda.launches
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks).to(cuda)}, cache_len=120)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    logits2, _ = m.decode_step(params, caches, nxt.to(cuda), 100)
    wit, wit_caches = m_dense.prefill(params, {"tokens": torch.from_numpy(toks).to(cuda)}, cache_len=120)
    wit2, _ = m_dense.decode_step(params, wit_caches, nxt.to(cuda), 100)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    params_cpu = params.to("cpu")
    if dtype == torch.float32:
        # The reference: a float64 prefill of the same weights, cast back.
        # The port's float32 CPU route moved now and then on the card's host
        # (ROADMAP C4: one ``apply_rope`` call 1.1e-4 off float64 in a
        # failing run, right when made again), while both card routes
        # stayed within 5e-6 of float64.
        # The decode step wrote position 100 into the caches in place: its
        # k is the float64 prefill's of the 101 tokens.
        ref = _float64_prefill(params_cpu, cfg, toks)[1]
        ks, ref2 = _float64_prefill(params_cpu, cfg, np.concatenate([toks, nxt.numpy()], axis=1))
        ref_k = torch.zeros(caches[0][0]["k"].shape, dtype=torch.float64)
        ref_k[:, :, : toks.shape[1] + 1] = torch.stack(ks)
    else:
        m_cpu = build_model(cfg, device="cpu")
        ref, ref_caches = m_cpu.prefill(params_cpu, {"tokens": torch.from_numpy(toks)}, cache_len=120)
        ref_k = ref_caches[0][0]["k"]
        ref2, _ = m_cpu.decode_step(params_cpu, ref_caches, nxt, 100)
    tol = _TOL[dtype]
    for got, w, exp in ((logits, wit, ref), (caches[0][0]["k"], wit_caches[0][0]["k"], ref_k), (logits2, wit2, ref2)):
        got, w, exp = got.cpu().float(), w.cpu().float(), exp.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, exp, rtol=tol, atol=tol)
            torch.testing.assert_close(w, exp, rtol=tol, atol=tol)
        else:
            # bf16: the card and the CPU round three layers' activations at
            # other places, and no two routes are elementwise within 3e-2
            # here, the kernel-free ones included (the witness against the
            # CPU, or the CPU's chunked against its dense). So the kernel
            # route is held, in RMS over the tensor, within 3e-2 of the CPU
            # and no further from it than 1.5x the witness is.
            err, err_wit = _rel_rms(got, exp), _rel_rms(w, exp)
            assert err <= tol and err <= 1.5 * err_wit, (err, err_wit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemma3_prefill_on_card_launches_windowed_kernels_on_local_layers(cuda, dtype):
    """Gemma3-12B at reduced width and depth (one group: 5 local layers with
    window 32 + 1 global, hd 256): one launch per layer, windowed on the
    local ones, and the prefill's logits and caches, and a decode step past
    the window, as on the CPU."""
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(), attn_impl="chunked", head_dim=256,
                              param_dtype=dtype)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
    params = m.init(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32)
    nxt = torch.from_numpy(toks[:, :1].copy())
    before = (flash_attention_cuda.launches, flash_attention_cuda.windowed_launches)
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks).to(cuda)}, cache_len=120)
    assert (flash_attention_cuda.launches - before[0], flash_attention_cuda.windowed_launches - before[1]) == (6, 5)
    logits2, _ = m.decode_step(params, caches, nxt.to(cuda), 100)
    assert flash_attention_cuda.launches - before[0] == 6
    params_cpu = params.to("cpu")
    ref, ref_caches = m_cpu.prefill(params_cpu, {"tokens": torch.from_numpy(toks)}, cache_len=120)
    ref2, _ = m_cpu.decode_step(params_cpu, ref_caches, nxt, 100)
    tol = _TOL[dtype]
    for got, exp in ((logits, ref), (caches[0][0]["k"], ref_caches[0][0]["k"]), (logits2, ref2)):
        got, exp = got.cpu().float(), exp.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, exp, rtol=tol, atol=tol)
        else:  # as in test_decoder_prefill_on_card_launches_the_kernel_per_layer
            assert _rel_rms(got, exp) <= tol
    assert torch.equal(caches[0][0]["pos_idx"].cpu(), ref_caches[0][0]["pos_idx"])


@pytest.mark.cuda
def test_moe_prefill_on_card_launches_the_kernel_per_layer(cuda):
    """Qwen1.5-MoE at reduced width and depth in float32 (2 layers of
    attention + 4 experts top-2 + a shared FFN, 16 / 16 heads as the full
    model): one flash launch a layer, none a decode step; the routing's
    expert ids equal the CPU's, and so do the logits, caches and a decode
    step within 2e-4."""
    from repro_torch.models import build_model

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), attn_impl="chunked", n_kv_heads=4,
                              param_dtype=torch.float32, moe_group=32)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
    params = m.init(0)
    params_cpu = copy.deepcopy(params).to("cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    nxt = torch.from_numpy(toks[:, :1].copy())
    before = flash_attention_cuda.launches
    with chip_smoke.recorded_routing() as card_ids:
        logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks).to(cuda)}, cache_len=100)
        assert flash_attention_cuda.launches == before + cfg.n_layers
        logits2, _ = m.decode_step(params, caches, nxt.to(cuda), 96)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    with chip_smoke.recorded_routing() as cpu_ids:
        ref, ref_caches = m_cpu.prefill(params_cpu, {"tokens": torch.from_numpy(toks)}, cache_len=100)
        ref2, _ = m_cpu.decode_step(params_cpu, ref_caches, nxt, 96)
    assert len(card_ids) == len(cpu_ids) == 2 * cfg.n_layers
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card_ids, cpu_ids))
    check = chip_smoke.moe_layer0_check(params, cfg, torch.from_numpy(toks).to(cuda))
    assert check["expert_ids_equal"] and check["rel_err"] < 2e-4, check
    for got, exp in ((logits, ref), (caches[0][0]["k"], ref_caches[0][0]["k"]), (logits2, ref2)):
        torch.testing.assert_close(got.cpu(), exp, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-tiny"])
def test_mamba2_and_whisper_on_card_match_cpu(cuda, arch, dtype):
    """Reduced Mamba2 (chunk 8) and Whisper on the card against the CPU:
    a prefill (over frame embeddings for Whisper), its caches, and decode
    steps on them; no flash launch. bf16 is held in RMS over the tensor, as
    test_decoder_prefill_on_card_launches_the_kernel_per_layer does."""
    from repro_torch.models import build_model

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
    params = m.init(0)
    params_cpu = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)).to(dtype)
    extra = {"frames": frames} if cfg.enc_dec else {}
    card = chip_smoke.family_traffic(m, params, toks.to(cuda), 40, 48,
                                     **{k: v.to(cuda) for k, v in extra.items()})
    assert card["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}
    cpu = chip_smoke.family_traffic(m_cpu, params_cpu, toks, 40, 48, **extra)
    tol = _TOL[dtype]
    got_leaves = [t for t in _cache_leaves(card["caches"])]
    exp_leaves = [t for t in _cache_leaves(cpu["caches"])]
    assert [tuple(t.shape) for t in got_leaves] == [tuple(t.shape) for t in exp_leaves]
    for got, exp in zip(got_leaves, exp_leaves):
        got, exp = got.cpu().float(), exp.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, exp, rtol=tol, atol=tol)
        else:
            assert _rel_rms(got, exp) <= tol
    limit = chip_smoke.DECODE_REL_LIMIT["float32" if dtype == torch.float32 else "bfloat16"]
    assert card["decode_vs_prefill_rel_err"] < limit and cpu["decode_vs_prefill_rel_err"] < limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minicpm3_prefill_on_card_launches_the_kernel_per_layer(cuda, dtype):
    """MiniCPM3-4B at reduced width and depth (2 layers) with its own head
    dims (qk 64 + 32, v 64): one launch a layer at (96, 64), none a decode
    step; the prefill's logits and latent caches, and an absorbed decode
    step, as on the CPU."""
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("minicpm3-4b").reduced(), attn_impl="chunked", qk_nope_head_dim=64,
                              qk_rope_head_dim=32, v_head_dim=64, param_dtype=dtype)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
    params = m.init(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32)
    nxt = torch.from_numpy(toks[:, :1].copy())
    before = flash_attention_cuda.launches
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks).to(cuda)}, cache_len=120)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    logits2, _ = m.decode_step(params, caches, nxt.to(cuda), 100)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    params_cpu = copy.deepcopy(params).to("cpu")
    ref, ref_caches = m_cpu.prefill(params_cpu, {"tokens": torch.from_numpy(toks)}, cache_len=120)
    ref2, _ = m_cpu.decode_step(params_cpu, ref_caches, nxt, 100)
    tol = _TOL[dtype]
    for got, exp in ((logits, ref), (caches[0][0]["ckv"], ref_caches[0][0]["ckv"]),
                     (caches[0][0]["kr"], ref_caches[0][0]["kr"]), (logits2, ref2)):
        got, exp = got.cpu().float(), exp.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, exp, rtol=tol, atol=tol)
        else:  # as in test_decoder_prefill_on_card_launches_the_kernel_per_layer
            assert _rel_rms(got, exp) <= tol


def _cache_leaves(tree):
    """The tensors of a nested tuple / dict cache tree, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _cache_leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.cuda
def test_chunked_mha_on_card_takes_no_plain_route(cuda):
    from repro_torch.models.layers import AttnSpec, init_attention, mha

    spec = AttnSpec(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, impl="chunked")
    p = init_attention(torch.Generator(device=cuda).manual_seed(0), spec, torch.float32, cuda)
    x = torch.randn(1, 8, 64, device=cuda)
    positions = torch.arange(8, device=cuda)[None]
    with pytest.raises(ValueError, match="mask_offset"):
        mha(p, spec, x, positions, mask_offset=4)
    spec48 = dataclasses.replace(spec, head_dim=48)
    p48 = init_attention(torch.Generator(device=cuda).manual_seed(0), spec48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        mha(p48, spec48, x, positions)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_chunked_mha_on_card_trains_through_the_kernels(cuda, dtype, window):
    """Under grad ``mha(impl="chunked")`` on the card launches the forward
    kernel once and the backward kernel once; its output and the gradients
    of x and every parameter are the plain route's (the same layer on the
    CPU, autograd through ``chunked_attention``): within 2e-4 in float32,
    a relative RMS error of 3e-2 in bf16. Under no_grad it launches the
    forward alone."""
    from repro_torch.models.layers import AttnSpec, init_attention, mha

    spec = AttnSpec(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, impl="chunked", window=window)
    p = init_attention(torch.Generator(device=cuda).manual_seed(0), spec, dtype, cuda)
    p_cpu = copy.deepcopy(p).to("cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 40, 64)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 40, 64)).astype(np.float32)).to(dtype)
    positions = torch.arange(40)[None].expand(2, 40)
    before = (flash_attention_cuda.launches, flash_attention_cuda.backward_launches)
    xc = x.to(cuda).requires_grad_()
    y = mha(p, spec, xc, positions.to(cuda))
    grads = torch.autograd.grad(y, [xc, *p.parameters()], dy.to(cuda))
    assert (flash_attention_cuda.launches - before[0], flash_attention_cuda.backward_launches - before[1]) == (1, 1)
    xr = x.clone().requires_grad_()
    y_ref = mha(p_cpu, spec, xr, positions)
    grads_ref = torch.autograd.grad(y_ref, [xr, *p_cpu.parameters()], dy)
    for got, exp in zip([y, *grads], [y_ref, *grads_ref]):
        got, exp = got.detach().cpu().float(), exp.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, exp, rtol=2e-4, atol=2e-4)
        else:
            assert _rel_rms(got, exp) <= 3e-2
    with torch.no_grad():
        mha(p, spec, xc, positions.to(cuda))
    assert (flash_attention_cuda.launches - before[0], flash_attention_cuda.backward_launches - before[1]) == (2, 1)


# The backward kernel against its plain twin (chip_smoke.FlashBwdCheck: the
# forward kernel's lse against the plain one, then dq, dk and dv within
# FLASH_BWD_RTOL): every pair of head dims, GQA, windows, Sq != Skv both
# ways (rows that see no key, keys no query sees), lengths on either side
# of the 64-row tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,vd", [(32, 32), (64, 64), (128, 128), (256, 256), (96, 64)])
@pytest.mark.parametrize("sq,skv,h,kh,causal,window", [
    (63, 63, 4, 2, True, 0), (65, 65, 4, 4, True, 0), (129, 129, 8, 1, True, 0), (200, 200, 4, 2, False, 0),
    (300, 100, 4, 2, True, 64), (100, 300, 4, 2, True, 0), (257, 129, 4, 2, False, 0), (300, 300, 8, 2, True, 37),
])
def test_flash_backward_kernel_matches_its_plain_twin(cuda, dtype, hd, vd, sq, skv, h, kh, causal, window):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    q, k, v = _qkv((1, sq, h, hd), (1, skv, kh, hd), dtype, sq + skv + hd + h, cuda, shape_v=(1, skv, kh, vd))
    before = flash_attention_cuda.backward_launches
    check = chip_smoke.FlashBwdCheck()
    check(q, k, v, causal=causal, window=window, what="backward", gen=torch.Generator(device=cuda).manual_seed(sq))
    assert check.mismatches == 0 and flash_attention_cuda.backward_launches == before + 1


@pytest.mark.cuda
def test_flash_backward_kernel_takes_strided_and_misaligned_grads(cuda):
    """A dO that autograd hands over strided, or in bf16 off a 16-byte
    boundary, gives the gradients of its contiguous copy bit for bit;
    shapes the kernel does not take raise before any launch."""
    from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda

    q, k, v = _qkv((2, 100, 4, 64), (2, 100, 2, 64), torch.bfloat16, 3, cuda)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn(o.shape, device=cuda).to(torch.bfloat16)
    want = flash_attention_bwd_cuda(q, k, v, o, lse, dout)
    strided = torch.randn((2, 100, 4, 128), device=cuda).to(torch.bfloat16)[..., :64]
    strided.copy_(dout)
    shifted = torch.zeros(dout.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(dout.shape)
    shifted.copy_(dout)
    assert shifted.data_ptr() % 16
    for d in (strided, shifted):
        assert all(torch.equal(a, b) for a, b in zip(flash_attention_bwd_cuda(q, k, v, o, lse, d), want))
    before = flash_attention_cuda.backward_launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, v, o, lse[:, :, :50], dout)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd_cuda(*(t[..., :48] for t in (q, k, v, o)), lse, dout[..., :48])
    assert flash_attention_cuda.backward_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hd,vd,sq,h,kh,window,split", [
    (128, 128, 700, 8, 2, 0, 4), (256, 256, 700, 10, 1, 100, 10), (96, 64, 300, 4, 4, 0, 1),
    (64, 64, 4096, 32, 8, 0, 1),
])
def test_flash_backward_kernel_repeats_bit_for_bit(cuda, hd, vd, sq, h, kh, window, split):
    """The bf16 backward twice more on the same inputs gives dq, dk and dv
    equal to the first bit for bit: every element is one thread's sum in a
    fixed order, and where the wrapper splits a group's query heads over
    blocks (``split``, on an H100's 132 SMs) their fp32 parts are added in
    split order."""
    from repro_torch.kernels.flash_attn import bwd_head_split, flash_attention_bwd_cuda

    q, k, v = _qkv((1, sq, h, hd), (1, sq, kh, hd), torch.bfloat16, sq + hd, cuda, shape_v=(1, sq, kh, vd))
    o, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    dout = torch.randn(o.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(hd)).to(torch.bfloat16)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window),
                                                         first))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sms != 132 or bwd_head_split(1, sq, kh, h // kh, hd, sms) == split


# Every arch of the registry, reduced, in float32; LLaVA-NeXT also under
# remat="dots"; one case with int8 gradient compression (error feedback).
# Then every arch with self-attention again through attn_impl="chunked":
# the flash kernels forward and backward (Whisper's attention stays dense
# in the reference and the port; Mamba2 has none). MiniCPM3 takes its own
# head dims there (qk 64 + 32, v 64), as the reduced (24, 16) is no
# pair of the kernels.
_SELF_ATTENTION = ("qwen2.5-32b", "gemma3-12b", "recurrentgemma-2b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                   "minicpm3-4b", "qwen1.5-110b")
TRAIN_CASES = [("llava-next-mistral-7b", "full", False, "dense"), ("llava-next-mistral-7b", "dots", False, "dense")] + [
    (arch, "full", False, "dense") for arch in ("qwen2.5-32b", "gemma3-12b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
                                                 "llama4-scout-17b-a16e", "mamba2-1.3b", "minicpm3-4b",
                                                 "whisper-tiny", "qwen1.5-110b")
] + [("qwen2.5-32b", "full", True, "dense")] + [
    ("llava-next-mistral-7b", "full", False, "chunked"), ("llava-next-mistral-7b", "dots", False, "chunked")
] + [(arch, "full", False, "chunked") for arch in _SELF_ATTENTION]


@contextlib.contextmanager
def _recorded_int8():
    """(int8 values, step) of every gradient the optimizer quantizes
    inside the block, in call order (one call a parameter and update)."""
    from repro_torch.optim import adamw

    calls, inner = [], adamw._quantize_int8

    def quantize(g):
        out = inner(g)
        calls.append((out[0], float(out[1])))
        return out

    adamw._quantize_int8 = quantize
    try:
        yield calls
    finally:
        adamw._quantize_int8 = inner


@contextlib.contextmanager
def _recorded_grads():
    """The gradients the optimizer is handed inside the block, one
    {parameter name: float32 gradient on the CPU} a step."""
    from repro_torch.train import loop

    calls, inner = [], loop.adamw_update

    def update(named, grads, *args, **kwargs):
        calls.append({n: g.detach().float().cpu().clone() for n, g in grads.items()})
        return inner(named, grads, *args, **kwargs)

    loop.adamw_update = update
    try:
        yield calls
    finally:
        loop.adamw_update = inner


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat,compress,attn", TRAIN_CASES,
                         ids=[f"{a}-{r}-{c}" + ("-chunked" if i == "chunked" else "") for a, r, c, i in TRAIN_CASES])
def test_train_loop_on_card_matches_cpu(cuda, arch, remat, compress, attn):
    """Two train steps of a reduced model of ``arch`` (float32, 2
    microbatches) on the card give the CPU's losses and train state within
    2e-4; each checkpoint-hook save launches the cut and fingerprint
    kernels once. LLaVA-NeXT's batches carry patch embeddings and
    Whisper's frame embeddings; the MoE archs route every token to the
    CPU's experts. With int8 gradient compression the card's int8 values
    equal the CPU's but for elements one step apart (a float32 gradient at
    a rounding edge), at most 1 in 1,000: every leaf is held within 2e-4
    at the other elements, and at those each ``err`` leaf within its
    tensor's two steps (and 2e-4); the moments and weights there follow
    the rounded gradient and are not compared. The gradients the optimizer
    is handed are held within 2e-4 at every element and step. Through
    attn_impl="chunked" (the flash kernels on the card, autograd through
    ``chunked_attention`` on the CPU) an element whose gradient is at
    rounding noise can take the other sign on the card, and AdamW's first
    steps move it by the learning rate either way (ROADMAP C4): such
    elements, at most 1 in 1,000 with the int8 ones, are left out of the
    weight and moment comparison, as the int8 ones are; their gradients
    are held with the rest."""
    from repro_torch.checkpoint import DedupCheckpointer
    from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.convert import _tree_of_named, train_state_from_tree, train_state_to_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.train.loop import init_train_state

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=torch.float32, remat=remat, attn_impl=attn)
    if attn == "chunked" and cfg.v_head_dim:
        cfg = dataclasses.replace(cfg, qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64)
    rng = np.random.default_rng(0)
    extra = {}
    if cfg.frontend == "vision_stub":
        extra["patch_embeds"] = rng.standard_normal((4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        extra["frame_embeds"] = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)

    class Data:
        text = SyntheticLMData(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=2)

        def batch(self, step):
            return {**self.text.batch(step), **{k: v + step for k, v in extra.items()}}

    tc = TrainConfig(steps=2, accum=2, log_every=1, checkpoint_every=1,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4, compress_grads=compress))
    cpu_model, card_model = build_model(cfg, device="cpu"), build_model(cfg)
    cpu_init = init_train_state(cpu_model, 0, tc.opt)
    card_init = train_state_from_tree(train_state_to_tree(cpu_init, cfg), cfg)  # copies to the card
    with chip_smoke.recorded_routing() as cpu_ids, _recorded_int8() as cpu_q, _recorded_grads() as cpu_g:
        cpu_state, cpu_hist = train_loop(cpu_model, Data(), tc, state=cpu_init)
    ckpt = DedupCheckpointer(DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 64 * 1024)))
    cut0, fp0 = cdc_cut_positions_cuda.launches, fingerprint_chunks_cuda.launches
    fwd0, bwd0 = flash_attention_cuda.launches, flash_attention_cuda.backward_launches
    with chip_smoke.recorded_routing() as card_ids, _recorded_int8() as card_q, _recorded_grads() as card_g:
        card_state, card_hist = train_loop(card_model, Data(), tc, checkpointer=ckpt, state=card_init)
    assert (cdc_cut_positions_cuda.launches - cut0, fingerprint_chunks_cuda.launches - fp0) == (2, 2)
    fwd, bwd = flash_attention_cuda.launches - fwd0, flash_attention_cuda.backward_launches - bwd0
    # "chunked": every attention layer and microbatch of both steps runs the
    # backward once and the forward twice (recomputed under remat)
    assert (bwd > 0 and fwd == 2 * bwd) if attn == "chunked" else (fwd, bwd) == (0, 0), (fwd, bwd)
    assert [h["step"] for h in card_hist] == [0, 1]
    assert len(card_ids) == len(cpu_ids) and bool(cpu_ids) == bool(cfg.n_experts)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card_ids, cpu_ids))
    np.testing.assert_allclose([h["loss"] for h in card_hist], [h["loss"] for h in cpu_hist], rtol=2e-4, atol=2e-4)
    names = list(dict(cpu_state["params"].named_parameters()))
    assert len(card_q) == len(cpu_q) == (2 * len(names) if compress else 0)
    edge = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in cpu_state["params"].named_parameters()}
    steps = dict.fromkeys(names, 0.0)
    for i, ((a, step), (b, _)) in enumerate(zip(card_q, cpu_q)):
        d = (a.cpu().to(torch.int16) - b.to(torch.int16)).abs()
        assert int(d.max()) <= 1, names[i % len(names)]
        edge[names[i % len(names)]] |= d.bool()
        steps[names[i % len(names)]] += step
    assert len(card_g) == len(cpu_g) == 2
    for i, (got, exp) in enumerate(zip(card_g, cpu_g)):
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), exp[n].numpy(), rtol=2e-4, atol=2e-4, err_msg=f"{n}, step {i}")
            if attn == "chunked":
                edge[n] |= torch.sign(got[n]) != torch.sign(exp[n])
    n_edge = sum(int(m.sum()) for m in edge.values())
    assert n_edge <= sum(m.numel() for m in edge.values()) // 1000, n_edge
    moments = [k for k in ("master", "mu", "nu", "err") if k in cpu_state["opt"]]
    mask_of = dict(_leaf_paths({"params": _tree_of_named(edge, cfg),
                                "opt": {k: _tree_of_named(edge, cfg) for k in moments}}))
    step_of = dict(_leaf_paths(_tree_of_named({n: torch.full(p.shape, steps[n]) for n, p in edge.items()}, cfg)))
    card_tree = train_state_to_tree(card_state, cfg)
    cpu_tree = train_state_to_tree(cpu_state, cfg)
    for (key, a), (_, b) in zip(_leaf_paths(card_tree), _leaf_paths(cpu_tree)):
        assert a.device.type == "cuda", key
        a, b = a.cpu().float().numpy(), b.float().numpy()
        at_edge = mask_of[key].numpy() if key in mask_of else np.zeros(a.shape, dtype=bool)
        np.testing.assert_allclose(a[~at_edge], b[~at_edge], rtol=2e-4, atol=2e-4, err_msg=key)
        if key.startswith("['opt']/['err']/") and at_edge.any():
            bound = step_of[key.removeprefix("['opt']/['err']/")].numpy()[at_edge] + 2e-4
            assert (np.abs(a[at_edge] - b[at_edge]) <= bound).all(), key
