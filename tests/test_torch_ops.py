"""The port's ``kernels.ops`` held against the JAX package's ``kernels.ops``.

Same seeded numpy inputs through both packages on the CPU (the JAX side on
its jnp oracles, the port on its plain torch twins). Every output is
integers or bytes, so the tolerance is 0 everywhere.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import chunking as jchunking
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import chunking as tchunking
from repro_torch.kernels import ops as tops

RNG_SEED = 42


def _wave(buf_bytes: int) -> list[np.ndarray]:
    """The seed-15 wave of benchmarks/write_path_bench.py::bench_device_cdc:
    one dominant stream and smaller stragglers."""
    rng = np.random.default_rng(15)
    weights = [8, 4, 2, 1, 1]
    sizes = [max(1, buf_bytes * w // sum(weights)) for w in weights]
    return [rng.integers(0, 256, size=s, dtype=np.uint8) for s in sizes]


_WAVE_KW = dict(mask=jchunking.cdc_mask(8 * 1024), min_size=4 * 1024, max_size=16 * 1024)


def _pinned(res) -> tuple[int, int]:
    """(n_chunks, boundary_checksum) as the bench computes them."""
    n_chunks, checksum = 0, 0
    for cutpos, n_cuts, _, nc in res:
        n_chunks += int(nc)
        checksum = (checksum + int(np.asarray(cutpos)[: int(n_cuts)].astype(np.uint64).sum())) % (1 << 32)
    return n_chunks, checksum


@pytest.mark.parametrize(
    "dtype,shape",
    [
        ("uint8", (7,)), ("uint8", (128,)), ("uint8", (3, 5)),
        ("bfloat16", (33,)), ("bfloat16", (16, 16)),
        ("float16", (9,)), ("float16", (64,)),
        ("float32", (1,)), ("float32", (17, 3)),
        ("float64", (5,)), ("float64", (8, 8)),
        ("int64", (3,)), ("int64", (31,)),
        ("bool", (13,)),
    ],
)
def test_tensor_to_u32_and_u8_match_numpy_bytes(dtype, shape):
    rng = np.random.default_rng(RNG_SEED)
    n = int(np.prod(shape))
    if dtype == "bool":
        host = rng.integers(0, 2, size=shape) > 0
        t = torch.from_numpy(host)
    elif dtype == "bfloat16":
        host = rng.integers(0, 2**16, size=shape, dtype=np.uint16)
        t = torch.from_numpy(host).view(torch.bfloat16)
    elif np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(dtype)
        host = rng.integers(info.min, info.max, size=shape, dtype=dtype)
        t = torch.from_numpy(host)
    else:
        host = rng.standard_normal(n).reshape(shape).astype(dtype)
        t = torch.from_numpy(host)
    raw = (host.astype(np.uint8) if dtype == "bool" else host).tobytes()
    exp = np.frombuffer(raw + b"\0" * ((-len(raw)) % 4), "<u4")
    np.testing.assert_array_equal(tops.tensor_to_u32(t).numpy(), exp)
    np.testing.assert_array_equal(tops.tensor_to_u8(t).numpy(), np.frombuffer(raw, np.uint8))


def test_row_geometry_matches_reference():
    for max_size in (1, 4, 97, 700, 16 * 1024, 1 << 20):
        assert tops.fp_row_words(max_size) == jops.fp_row_words(max_size)
    for n, mn in ((1, 1), (4096, 64), (1 << 20, 256 * 1024)):
        assert tops._max_cuts(n, mn) == jops._max_cuts(n, mn)


def test_seed15_wave_pins_and_matches_jax():
    """The fused op reproduces the bench's pinned 0.25 MiB columns and the
    JAX call stream by stream (first n_cuts cut positions, first n_chunks
    fingerprints)."""
    streams = _wave(256 * 1024)
    got = tops.cdc_cut_and_fingerprint_many([torch.from_numpy(s) for s in streams], **_WAVE_KW)
    assert _pinned(got) == (24, 956437)
    exp = jops.cdc_cut_and_fingerprint_many(
        [jnp.asarray(s) for s in streams], use_pallas=False, **_WAVE_KW
    )
    for (gc, gn, gf, gk), (ec, en, ef, ek) in zip(got, exp):
        assert (gn, gk) == (int(en), int(ek))
        assert gc.shape == ec.shape and gf.shape == ef.shape
        np.testing.assert_array_equal(gc.numpy(), np.asarray(ec))
        np.testing.assert_array_equal(gf.numpy()[:gk], np.asarray(ef)[:gk])


def test_seed15_wave_pins_at_2mib():
    streams = _wave(2 * 1024 * 1024)
    got = tops.cdc_cut_and_fingerprint_many([torch.from_numpy(s) for s in streams], **_WAVE_KW)
    assert _pinned(got) == (201, 71402112)


def test_fused_wave_matches_host_rows_and_chunker():
    rng = np.random.default_rng(23)
    spec = jchunking.ChunkingSpec("cdc", 256, 64, 700)
    streams = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (3000, 64, 1, 517)]
    res = tops.cdc_cut_and_fingerprint_many(
        [torch.from_numpy(s) for s in streams], spec=tchunking.ChunkSpec.cdc(256, min_bytes=64, max_bytes=700)
    )
    row_words, width = jops.fp_row_words(700)
    for s, (cutpos, n_cuts, fps, n_chunks) in zip(streams, res):
        chunks = list(jchunking.chunk_cdc_scalar(s.tobytes(), spec))
        assert n_chunks == len(chunks)
        ends = np.cumsum([len(c) for c in chunks]) - 1
        np.testing.assert_array_equal(cutpos.numpy()[:n_cuts], ends[:n_cuts])
        rows = np.zeros((len(chunks), width), np.uint32)
        for i, c in enumerate(chunks):
            rows[i, :row_words] = np.frombuffer(c + b"\0" * (row_words * 4 - len(c)), "<u4")
            rows[i, row_words] = len(c)
        np.testing.assert_array_equal(fps.numpy()[:n_chunks], np.asarray(jref.fingerprint_chunks(jnp.asarray(rows))))


def test_fused_wave_one_launch_pair_and_empty_streams():
    rng = np.random.default_rng(29)
    s = torch.from_numpy(rng.integers(0, 256, size=2048, dtype=np.uint8))
    empty = torch.zeros((0,), dtype=torch.uint8)
    before = tops.launch_snapshot()
    res = tops.cdc_cut_and_fingerprint_many([empty, s, empty], mask=255, min_size=64, max_size=512)
    after = tops.launch_snapshot()
    assert (after["cdc"] - before["cdc"], after["fingerprint"] - before["fingerprint"]) == (1, 1)
    assert [r[3] for r in res][0::2] == [0, 0] and res[1][3] > 0
    assert res[0][0].shape == (0,) and res[0][2].shape == (0, 4)
    exp = jops.cdc_cut_and_fingerprint_many(
        [jnp.zeros((0,), jnp.uint8), jnp.asarray(s.numpy()), jnp.zeros((0,), jnp.uint8)],
        mask=255, min_size=64, max_size=512, use_pallas=False,
    )
    np.testing.assert_array_equal(res[1][2].numpy()[: res[1][3]], np.asarray(exp[1][2])[: int(exp[1][3])])
    one = tops.cdc_cut_and_fingerprint(s, mask=255, min_size=64, max_size=512)
    assert one[1] == res[1][1] and torch.equal(one[0], res[1][0])
    # an all-empty wave launches nothing
    before = tops.launch_snapshot()
    res = tops.cdc_cut_and_fingerprint_many([empty], mask=255, min_size=64, max_size=512)
    assert tops.launch_snapshot() == before and res[0][3] == 0


def test_fingerprint_tensor_chunks_match_jax():
    rng = np.random.default_rng(7)
    host = [
        rng.standard_normal((32, 64)).astype(np.float32),
        rng.integers(0, 2**16, size=(33, 7), dtype=np.uint16),
        rng.integers(-(2**31), 2**31, size=(1000,), dtype=np.int32),
    ]
    tt = [torch.from_numpy(host[0]), torch.from_numpy(host[1]).view(torch.bfloat16), torch.from_numpy(host[2])]
    jt = [jnp.asarray(host[0]), jnp.asarray(host[1]).view(jnp.bfloat16), jnp.asarray(host[2])]
    got = tops.fingerprint_tensor_chunks_many(tt, chunk_bytes=2048)
    exp = jops.fingerprint_tensor_chunks_many(jt, chunk_bytes=2048, use_pallas=False)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    np.testing.assert_array_equal(
        tops.fingerprint_tensor_chunks(tt[0], 2048).numpy(), np.asarray(exp[0])
    )
    words = host[2].view(np.uint32).reshape(8, 125)
    np.testing.assert_array_equal(
        tops.fingerprint_chunks(torch.from_numpy(words)).numpy(),
        np.asarray(jops.fingerprint_chunks(jnp.asarray(words), use_pallas=False)),
    )
    assert [(f.namespace, f.value) for f in tops.device_fps_to_host(got[2])] == [
        (f.namespace, f.value) for f in jops.device_fps_to_host(exp[2])
    ]


def test_window_hashes_and_cut_offsets_match_host():
    data = np.random.default_rng(5).integers(0, 256, size=20_000, dtype=np.uint8)
    t = torch.from_numpy(data)
    host = jchunking.window_hashes(data.tobytes())
    np.testing.assert_array_equal(tops.cdc_window_hashes(t).numpy(), host)
    np.testing.assert_array_equal(tops.cdc_boundaries(t, 255).numpy(), (host & 255) == 0)
    spec = tchunking.ChunkSpec.cdc(1024)
    cand = jchunking._cdc_candidates(data.tobytes(), spec.mask)
    exp = jchunking._cdc_cuts(cand, data.size, spec.min_bytes, spec.max_bytes)
    np.testing.assert_array_equal(tops.cdc_cut_offsets(t, spec=spec), exp)
    assert tops.cdc_cut_offsets(t[:0], spec=spec).size == 0


def test_chunk_cdc_backends_on_cpu_match_scalar():
    data = np.random.default_rng(17).integers(0, 256, size=40 * 1024, dtype=np.uint8).tobytes()
    spec = tchunking.ChunkingSpec("cdc", 1024)
    exp = list(jchunking.chunk_cdc_scalar(data, jchunking.ChunkingSpec("cdc", 1024)))
    for backend in ("numpy", "kernel", "device"):
        assert list(tchunking.chunk_cdc(data, spec, backend=backend, device="cpu")) == exp


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError):
        tops.resolve_device()
    with pytest.raises(RuntimeError):
        tchunking.window_hashes(b"abc", backend="kernel")
    assert tops.resolve_device("cpu").type == "cpu"
