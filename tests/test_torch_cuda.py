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
causal inputs, whose elements are small.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def _qkv(shape_q, shape_kv, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in (shape_q, shape_kv, shape_kv))
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)]


_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _flash_close(q, k, v, **kw):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, **kw)
    assert flash_attention_cuda.launches == before + 1
    exp = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
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
@pytest.mark.parametrize("hd", [32, 64, 128])
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
# and its K/V ring tiles 128 rows. Lengths on either side of a tile, windows
# that cut through one, Sq > Skv, and whole-tile windows.
@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (127, 127, True, 0), (128, 128, True, 0), (129, 129, True, 0), (255, 255, True, 0), (257, 257, True, 0),
    (129, 129, False, 0), (257, 257, False, 0), (300, 300, True, 100), (400, 400, True, 129),
    (257, 129, True, 0), (384, 255, False, 0), (300, 127, True, 100), (640, 640, True, 128),
])
def test_flash_kernel_bf16_tiles(cuda, hd, sq, skv, causal, window):
    q, k, v = _qkv((1, sq, 4, hd), (1, skv, 2, hd), torch.bfloat16, 3 * sq + skv + hd, cuda)
    _flash_close(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
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


def _rel_rms(got: torch.Tensor, exp: torch.Tensor) -> float:
    return float((got - exp).square().mean().sqrt() / exp.square().mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_prefill_on_card_launches_the_kernel_per_layer(cuda, dtype):
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), attn_impl="chunked", n_layers=3, param_dtype=dtype)
    m, m_cpu = build_model(cfg), build_model(cfg, device="cpu")
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
    ref, ref_caches = m_cpu.prefill(params_cpu, {"tokens": torch.from_numpy(toks)}, cache_len=120)
    ref2, _ = m_cpu.decode_step(params_cpu, ref_caches, nxt, 100)
    tol = _TOL[dtype]
    for got, w, exp in ((logits, wit, ref), (caches[0][0]["k"], wit_caches[0][0]["k"], ref_caches[0][0]["k"]),
                        (logits2, wit2, ref2)):
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
def test_chunked_mha_on_card_raises_under_grad(cuda):
    """The flash kernel is forward only: under grad it raises rather than
    hand autograd a constant; under no_grad it runs, one launch."""
    from repro_torch.models.layers import AttnSpec, init_attention, mha

    spec = AttnSpec(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, impl="chunked")
    p = init_attention(torch.Generator(device=cuda).manual_seed(0), spec, torch.float32, cuda)
    x = torch.randn(1, 8, 64, device=cuda)
    positions = torch.arange(8, device=cuda)[None]
    assert any(t.requires_grad for t in p.parameters())
    before = flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match='attn_impl="dense"'):
        mha(p, spec, x, positions)
    assert flash_attention_cuda.launches == before
    with torch.no_grad():
        y = mha(p, spec, x, positions)
    assert flash_attention_cuda.launches == before + 1
    assert y.shape == (1, 8, 64) and bool(torch.isfinite(y).all())


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_loop_on_card_matches_cpu(cuda, remat):
    """Two train steps of reduced LLaVA-NeXT (float32, patch embeddings,
    2 microbatches) on the card give the CPU's losses and state within
    2e-4; each checkpoint-hook save launches the cut and fingerprint
    kernels once."""
    from repro_torch.checkpoint import DedupCheckpointer
    from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.convert import train_state_from_tree, train_state_to_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.train.loop import init_train_state

    cfg = dataclasses.replace(get_config("llava-next-mistral-7b").reduced(), param_dtype=torch.float32, remat=remat)
    rng = np.random.default_rng(0)
    patches = rng.standard_normal((4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)

    class Data:
        text = SyntheticLMData(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=2)

        def batch(self, step):
            return {**self.text.batch(step), "patch_embeds": patches + step}

    tc = TrainConfig(steps=2, accum=2, log_every=1, checkpoint_every=1,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    cpu_model, card_model = build_model(cfg, device="cpu"), build_model(cfg)
    cpu_init = init_train_state(cpu_model, 0, tc.opt)
    card_init = train_state_from_tree(train_state_to_tree(cpu_init, cfg), cfg)  # copies to the card
    cpu_state, cpu_hist = train_loop(cpu_model, Data(), tc, state=cpu_init)
    ckpt = DedupCheckpointer(DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 64 * 1024)))
    cut0, fp0 = cdc_cut_positions_cuda.launches, fingerprint_chunks_cuda.launches
    card_state, card_hist = train_loop(card_model, Data(), tc, checkpointer=ckpt, state=card_init)
    assert (cdc_cut_positions_cuda.launches - cut0, fingerprint_chunks_cuda.launches - fp0) == (2, 2)
    assert [h["step"] for h in card_hist] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in card_hist], [h["loss"] for h in cpu_hist], rtol=2e-4, atol=2e-4)
    card_tree = train_state_to_tree(card_state, cfg)
    cpu_tree = train_state_to_tree(cpu_state, cfg)
    for (key, a), (_, b) in zip(_leaf_paths(card_tree), _leaf_paths(cpu_tree)):
        assert a.device.type == "cuda", key
        np.testing.assert_allclose(a.cpu().float().numpy(), b.float().numpy(), rtol=2e-4, atol=2e-4, err_msg=key)
