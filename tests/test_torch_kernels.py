"""The port's kernel twins held against the JAX package's kernels.

Same seeded numpy inputs through ``repro.kernels`` (the jnp oracles and the
Pallas kernels in interpret mode) and ``repro_torch.kernels`` (the plain
torch twins, which is what a CPU tensor runs). Every output is integers, so
the tolerance is 0 everywhere. The CUDA kernels themselves are held
against these twins on the card by ``tests/test_torch_cuda.py``. The last
tests check host-side helpers of ``chip_smoke.py`` and
``tools/flash_planted_faults.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core.chunking import GEAR_TABLE, ChunkingSpec, cdc_mask, chunk_cdc_scalar, window_hash_at
from repro.kernels import ref as jref
from repro.kernels.cdc import cdc_cut_masks_pallas, cdc_hashes_pallas
from repro.kernels.fingerprint import fingerprint_chunks_pallas
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cdc import (
    cdc_cut_masks_cuda,
    cdc_cut_masks_plain,
    cdc_cut_positions_cuda,
    cdc_cut_positions_plain,
    cdc_hashes_cuda,
    gear_values,
)
from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda

_GEAR = np.array(GEAR_TABLE, dtype=np.uint32)
# The jnp oracles, compiled once per shape (eager jnp re-dispatches every op).
_jref_fingerprint = jax.jit(jref.fingerprint_chunks)
_jref_hashes = jax.jit(jref.cdc_hashes)


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32))


def test_constants_match_reference():
    for name in ("A", "B", "C"):
        np.testing.assert_array_equal(getattr(tref, name), getattr(jref, name))
    assert tref.LANES == jref.LANES and tref.WINDOW == jref.WINDOW


@pytest.mark.parametrize(
    "shape",
    [(1, 128), (2, 129), (5, 511), (8, 512), (13, 1000), (256, 512), (300, 700), (257, 513)],
)
def test_fingerprint_twin_matches_jax(shape):
    x = np.random.default_rng(shape[0] * 1000 + shape[1]).integers(0, 2**32, size=shape, dtype=np.uint32)
    got = fingerprint_chunks_cuda(_u32(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jref_fingerprint(jnp.asarray(x))))


@pytest.mark.parametrize("tc,tw", [(8, 128), (64, 256), (256, 512)])
def test_fingerprint_twin_matches_pallas_tiles(tc, tw):
    x = np.random.default_rng(tc * 7 + tw).integers(0, 2**32, size=(70, 600), dtype=np.uint32)
    p = fingerprint_chunks_pallas(jnp.asarray(x), interpret=True, tile_chunks=tc, tile_words=tw)
    np.testing.assert_array_equal(fingerprint_chunks_cuda(_u32(x)).numpy(), np.asarray(p))


def test_fingerprint_zero_words_count():
    """Zero words inside the row width still add fmix32(pos * B): rows of
    different widths with the same non-zero prefix differ."""
    x = np.zeros((1, 256), np.uint32)
    x[0, 0] = 7
    a = fingerprint_chunks_cuda(_u32(x)).numpy()
    b = fingerprint_chunks_cuda(_u32(x[:, :128])).numpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(_jref_fingerprint(jnp.asarray(x))))


@pytest.mark.parametrize("n", [33, 256, 2048, 5000, 16384])
def test_window_hashes_twin_matches_jax_and_host(n):
    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    got = cdc_hashes_cuda(torch.from_numpy(data)).numpy()
    tv = jnp.asarray(_GEAR[data])
    np.testing.assert_array_equal(got, np.asarray(_jref_hashes(tv)))
    np.testing.assert_array_equal(got, np.asarray(cdc_hashes_pallas(tv, interpret=True)))
    b = bytes(data)
    for i in [0, 1, 31, 32, n // 3, n - 1]:
        assert int(got[i]) == window_hash_at(b, i)


def test_gear_values_match_table():
    data = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(gear_values(torch.from_numpy(data)).numpy(), _GEAR.astype(np.int64))


# The 8-spec sweep of tests/test_cdc_cuts_device.py: (n, target, min, max),
# 0 = let normalized() pick.
SWEEP = [
    (3000, 256, 64, 1024),
    (4096, 64, 1, 97),
    (100, 1024, 60, 4096),
    (1, 16, 1, 8),
    (777, 32, 31, 33),
    (2048, 128, 100, 101),
    (1500, 64, 50, 50),
    (5000, 512, 0, 0),
]


def _pallas_cuts(data: bytes, spec: ChunkingSpec, block_len: int = 512) -> np.ndarray:
    spec = spec.normalized()
    tv = jnp.asarray(_GEAR[np.frombuffer(data, np.uint8)])
    m = cdc_cut_masks_pallas(
        [tv], mask=cdc_mask(spec.chunk_size), min_size=spec.min_size,
        max_size=spec.max_size, interpret=True, block_len=block_len,
    )[0]
    return np.flatnonzero(np.asarray(m))


def _scalar_loop_cuts(data: bytes, spec: ChunkingSpec) -> np.ndarray:
    """Inclusive chunk ends emitted by the byte-at-a-time scalar loop."""
    spec = spec.normalized()
    mask = cdc_mask(spec.chunk_size)
    cuts, start, i, n = [], 0, spec.min_size, len(data)
    while i < n:
        if (window_hash_at(data, i) & mask) == 0 or (i - start + 1) >= spec.max_size:
            cuts.append(i)
            start = i + 1
            i = start + spec.min_size
        else:
            i += 1
    return np.asarray(cuts, dtype=np.int64)


def _twin_cuts(data: bytes, spec: ChunkingSpec) -> np.ndarray:
    spec = spec.normalized()
    m = cdc_cut_masks_cuda(
        [torch.from_numpy(np.frombuffer(data, np.uint8).copy())],
        mask=cdc_mask(spec.chunk_size), min_size=spec.min_size, max_size=spec.max_size,
    )[0]
    return np.flatnonzero(m.numpy())


@pytest.mark.parametrize("n,target,mn,mx", SWEEP)
def test_cut_mask_twin_matches_pallas_and_scalar(n, target, mn, mx):
    data = np.random.default_rng(n * 31 + target).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    spec = ChunkingSpec("cdc", target, mn, mx)
    got = _twin_cuts(data, spec)
    np.testing.assert_array_equal(got, _scalar_loop_cuts(data, spec))
    np.testing.assert_array_equal(got, _pallas_cuts(data, spec))
    bounds = [0, *(int(c) + 1 for c in got)]
    chunks = [data[a:b] for a, b in zip(bounds, bounds[1:] + [len(data)]) if a < b]
    assert chunks == list(chunk_cdc_scalar(data, spec))


def test_cut_mask_twin_forced_cuts_and_short_tails():
    data = b"\x42" * 3000
    spec = ChunkingSpec("cdc", 128, 100, 300)
    assert _twin_cuts(data, spec).size > 0
    np.testing.assert_array_equal(_twin_cuts(data, spec), _scalar_loop_cuts(data, spec))
    rng = np.random.default_rng(9)
    spec = ChunkingSpec("cdc", 64, 48, 256)
    base = rng.integers(0, 256, size=1024, dtype=np.uint8).tobytes()
    last = int(_scalar_loop_cuts(base, spec)[-1])
    for extra in (1, 7, 47):
        data = base[: last + 1 + extra]
        np.testing.assert_array_equal(_twin_cuts(data, spec), _scalar_loop_cuts(data, spec))


def test_cut_mask_twin_multi_stream_wave_matches_pallas():
    """A wave keeps every stream's hash window and carry to itself."""
    rng = np.random.default_rng(23)
    spec = ChunkingSpec("cdc", 256, 64, 700)
    streams = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (3000, 64, 1, 517)]
    got = cdc_cut_masks_cuda(
        [torch.from_numpy(s) for s in streams],
        mask=cdc_mask(256), min_size=64, max_size=700,
    )
    exp = cdc_cut_masks_pallas(
        [jnp.asarray(_GEAR[s]) for s in streams],
        mask=cdc_mask(256), min_size=64, max_size=700, interpret=True, block_len=512,
    )
    for s, g, e in zip(streams, got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_array_equal(np.flatnonzero(g.numpy()), _scalar_loop_cuts(s.tobytes(), spec))


def test_cut_mask_rejects_bad_waves():
    s = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError):
        cdc_cut_masks_cuda([s, s[:0]], mask=255, min_size=4, max_size=16)
    with pytest.raises(ValueError):
        cdc_cut_masks_cuda([s], mask=255, min_size=0, max_size=16)


@pytest.mark.parametrize("n,target,mn,mx", SWEEP)
def test_cut_positions_twin_matches_scalar_and_pallas(n, target, mn, mx):
    """The positions output: the first n_cuts slots hold the scalar loop's
    cuts, the rest n; n_chunks counts the tail chunk too."""
    data = np.random.default_rng(n * 31 + target).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    spec = ChunkingSpec("cdc", target, mn, mx).normalized()
    kw = dict(mask=cdc_mask(spec.chunk_size), min_size=spec.min_size, max_size=spec.max_size)
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    [(pos, n_cuts, n_chunks)] = cdc_cut_positions_plain([t], **kw)
    [(via_wrapper, *counts)] = cdc_cut_positions_cuda([t], **kw)
    assert torch.equal(via_wrapper, pos) and counts == [n_cuts, n_chunks]
    assert pos.dtype == torch.int32 and pos.shape == (tops._max_cuts(n, spec.min_size),)
    np.testing.assert_array_equal(pos[:n_cuts].numpy(), _scalar_loop_cuts(data, spec))
    np.testing.assert_array_equal(pos[:n_cuts].numpy(), _pallas_cuts(data, spec))
    assert bool((pos[n_cuts:] == n).all())
    assert n_chunks == len(list(chunk_cdc_scalar(data, spec)))


@pytest.mark.parametrize("buf", [256 * 1024, 2 * 1024 * 1024])
def test_chunk_rows_from_positions_match_the_mask_route(buf):
    """The port's rows glue fed cut positions gives the JAX package's rows,
    cut positions, n_cuts and n_chunks fed the cut mask, on the seed-15
    waves; asked for n_chunks rows, it gives the first n_chunks of them."""
    import sys
    from pathlib import Path

    from repro.kernels import ops as jops

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    kw = dict(mask=cdc_mask(8 * 1024), min_size=4 * 1024, max_size=16 * 1024)
    streams = chip_smoke.seed15_wave(buf)
    tstreams = [torch.from_numpy(s) for s in streams]
    masks = cdc_cut_masks_plain(tstreams, **kw)
    cuts = cdc_cut_positions_cuda(tstreams, **kw)
    for s, t, m, (pos, n_cuts, n_chunks) in zip(streams, tstreams, masks, cuts):
        width = tops.fp_row_words(kw["max_size"])[1]
        rows = tops._chunk_rows(t, pos, n=s.shape[0], max_size=kw["max_size"],
                                out=torch.empty((pos.numel() + 1, width), dtype=torch.int32))
        head = tops._chunk_rows(t, pos, n=s.shape[0], max_size=kw["max_size"],
                                out=torch.empty((n_chunks, width), dtype=torch.int32))
        jrows, jpos, jn_cuts, jn_chunks = jops._chunk_rows(
            jnp.asarray(s), jnp.asarray(m.numpy()), n=s.shape[0], min_size=kw["min_size"], max_size=kw["max_size"]
        )
        assert (n_cuts, n_chunks) == (int(jn_cuts), int(jn_chunks))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(head.numpy(), np.asarray(jrows)[:n_chunks])


def test_cut_positions_reject_streams_of_2_gib():
    """Positions are int32, as in the JAX contract: a stream of 2^31 bytes
    or more raises before anything reads it."""
    big = torch.zeros(1, dtype=torch.uint8).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\^31"):
        cdc_cut_positions_cuda([big], mask=255, min_size=4, max_size=16)
    with pytest.raises(ValueError):
        cdc_cut_positions_cuda([torch.zeros(3, dtype=torch.uint8)], mask=255, min_size=8, max_size=4)


def test_cut_wrapper_constants_match_the_kernel_source():
    """The wrapper sizes the kernel's scratch and names its routes from
    constants of csrc/cdc.cu: the positions per phase-A tile, the list's
    slots per stream and the route numbers."""
    import re
    from pathlib import Path

    from repro_torch.kernels import cdc

    src = (Path(cdc.__file__).resolve().parent.parent / "csrc" / "cdc.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert cdc.TILE == const["kThreads"] * 32
    assert cdc.LIST_CAP == const["kListCap"]
    assert cdc.ROUTES[const["kRouteList"]] == "list" and cdc.ROUTES[const["kRouteBitmap"]] == "bitmap"


def test_params_from_numpy_needs_cuda_unless_told_cpu():
    """An entry point of the port runs on the card unless the caller asks
    for the CPU: without ``device`` the weights go to CUDA, and where there
    is none the call raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_numpy

    with pytest.raises(RuntimeError):
        params_from_numpy({}, get_config("qwen2.5-32b").reduced())


_SASS = """
\t\tFunction : _Z5otherv
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;             /* 0x0 */
        /*0010*/                   BRA 0x0;                                 /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_113fp_accumulateEPKjlPj
        /*0000*/                   IMAD.MOV.U32 R5, RZ, RZ, RZ ;            /* 0x000000ffff057224 */
                                                                            /* 0x000fe200078e00ff */
        /*0010*/                   ISETP.GE.U32.AND P0, PT, R4, UR8, PT ;   /* 0x0 */
        /*0020*/               @P0 BRA 0x70 ;                               /* 0x0 */
        /*0030*/                   LDG.E.CONSTANT R17, desc[UR6][R16.64] ;  /* 0x0 */
        /*0040*/                   IMAD R15, R17, -0x61c8864f, R10 ;        /* 0x0 */
        /*0050*/                   SHF.R.U32.HI R18, RZ, 0x10, R15 ;        /* 0x0 */
        /*0060*/                   LOP3.LUT R18, R18, R15, RZ, 0x3c, !PT ;  /* 0x0 */
        /*0070*/                   BSYNC B0 ;                               /* 0x0 */
        /*0080*/                   IADD3 R16, P4, R4, UR4, RZ ;             /* 0x0 */
        /*0090*/                   LDG.E.CONSTANT R17, desc[UR6][R16.64] ;  /* 0x0 */
        /*00a0*/                   VIADD R15, R15, 0x165667b1 ;             /* 0x0 */
        /*00b0*/                   BSYNC B0 ;                               /* 0x0 */
        /*00c0*/               @P1 BRA 0x10 ;                               /* 0x0 */
        /*00d0*/                   EXIT ;                                   /* 0x0 */
        /*00e0*/                   BRA 0xe0;                                /* 0x0 */
"""


def test_sass_ops_per_word_reads_the_inner_loop():
    """The fingerprint bound's count comes from the kernel's SASS: the loop a
    backward branch closes, its loads as words, and the integer operations
    after each load up to the end of that word's guarded block."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    issued, ops = chip_smoke.sass_ops_per_word(_SASS, "fp_accumulate")
    assert issued == 12 / 2  # 0x10..0xc0 inclusive, two loads
    assert ops == (3 + 1) / 2
    with pytest.raises(AssertionError):
        chip_smoke.sass_ops_per_word(_SASS.replace("@P1 BRA 0x10", "@P1 BRA 0xd0"), "fp_accumulate")


def test_flash_limit_scales_with_the_row():
    """chip_smoke's flash limit is relative to each element and to its row's
    RMS: an error of a tenth of a small row's scale fails it, where the
    reference's fixed 3e-2 would pass it."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    exp = torch.full((2, 8), 0.02)
    exp[1] = 0.0
    got = exp.clone()
    got[0, 0] += 0.002
    ratio = chip_smoke.flash_err_ratio(got, exp)
    assert float(ratio[0, 0]) == pytest.approx(0.002 / 0.04, rel=1e-4)
    assert float(ratio[0, 0]) > chip_smoke.FLASH_RTOL["bfloat16"]
    assert 0.002 <= 3e-2 + 3e-2 * 0.02
    assert float(ratio[0, 1:].max()) == 0.0 and float(ratio[1].max()) == 0.0  # equal, rows of 0 included
    got[1, 3] = 1e-6
    got[0, 5] = float("nan")
    ratio = chip_smoke.flash_err_ratio(got, exp)
    assert math.isinf(float(ratio[1, 3]))
    assert int((~(ratio <= chip_smoke.FLASH_RTOL["float32"])).sum()) == 3


def test_planted_faults_edit_both_kernels_loops():
    """tools/flash_planted_faults.py's mutants each add one skipped tile to
    the float32 kernel's KV loop and to the KV tile walk that the bfloat16
    kernel's producer and consumers share."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    import flash_planted_faults as planted

    src = (root / "src" / "repro_torch" / "csrc" / "flash_attn.cu").read_text()
    for skip in planted.MUTANTS.values():
        mutant = planted.mutant_source(src, skip)
        line = f"if (q0 >= a.Sq / 2 && t == {skip}) continue;"
        assert mutant.count(line) == 2
        simt = mutant.split("flash_fwd_simt(Args a)")[1].split("\n}\n")[0]
        walk = mutant.split("walk_kv_tiles(const Args& a, int q0, Visit&& visit)")[1].split("\n}\n")[0]
        assert line in simt and line in walk
        assert mutant.replace(f"    {line}\n", "") == src


def test_res_usage_reads_cuobjdump_text():
    """chip_smoke.res_usage keys each kernel of ``cuobjdump -res-usage`` by
    its name and head dim, with registers, stack and local bytes."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    text = (
        "Resource usage:\n Common:\n  GLOBAL:0\n"
        " Function _ZN46_GLOBAL__N__0_13_flash_attn_cu_015flash_fwd_wgmmaILi64EEEv14CUtensorMap_stS1_S1_NS_4ArgsE:\n"
        "  REG:168 STACK:0 SHARED:48 LOCAL:0 CONSTANT[0]:936 TEXTURE:0 SURFACE:0 SAMPLER:0\n"
        " Function _ZN46_GLOBAL__N__0_13_flash_attn_cu_014flash_fwd_simtIfLi32EEEvNS_4ArgsE:\n"
        "  REG:128 STACK:8 SHARED:0 LOCAL:4 CONSTANT[0]:512 TEXTURE:0 SURFACE:0 SAMPLER:0\n"
    )
    assert chip_smoke.res_usage(text) == {
        "flash_fwd_wgmma<64>": {"registers": 168, "stack_bytes": 0, "local_bytes": 0},
        "flash_fwd_simt<32>": {"registers": 128, "stack_bytes": 8, "local_bytes": 4},
    }
