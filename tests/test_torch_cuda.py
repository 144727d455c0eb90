"""The port's CUDA kernels held against their plain torch twins on the card.

Every test here is marked ``cuda`` and skips where torch sees no GPU. Run
them on a machine with an H100 (which needs no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Outputs are integers, so the tolerance is 0 everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.core.chunking import cdc_mask, chunk_cdc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cdc import cdc_cut_masks_cuda, cdc_hashes_cuda, gear_values
from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda

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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 5000, 8193, 1 << 20])
def test_window_hash_kernel_matches_twin(cuda, n):
    data = _bytes(n, n, cuda)
    before = cdc_hashes_cuda.launches
    got = cdc_hashes_cuda(data)
    assert cdc_hashes_cuda.launches == before + 1
    assert _same(got, ref.cdc_hashes(gear_values(data)))


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
