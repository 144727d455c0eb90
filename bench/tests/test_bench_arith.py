"""The yardstick's counts at small shapes: hand counts, and chip_smoke.py's
figures for the functions copied from it."""

import importlib.util
import math

import pytest

from bench.families import family
from bench.metrics import _arith as A
from conftest import ROOT


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _module(ROOT / "chip_smoke.py", "chip_smoke_for_bench")


def test_attention_pairs_by_hand():
    assert A.attention_pairs(4, 4, True, 0) == 1 + 2 + 3 + 4
    assert A.attention_pairs(4, 4, False, 0) == 16
    assert A.attention_pairs(5, 5, True, 2) == 1 + 2 + 2 + 2 + 2


def test_flash_bounds_by_hand():
    q, k, v = A.Shape((1, 4, 2, 8), 2), A.Shape((1, 4, 1, 8), 2), A.Shape((1, 4, 1, 8), 2)
    flop_ms, bytes_ms = A.flash_bound_ms(q, k, v, True, 0)
    assert flop_ms == pytest.approx(2 * 16 * 2 * 10 / 989e12 * 1e3)
    assert bytes_ms == pytest.approx((64 + 32 + 32 + 64) * 2 / 3.35e12 * 1e3)
    flop_ms, bytes_ms = A.flash_bwd_bound_ms(q, k, v, True, 0)
    assert flop_ms == pytest.approx(2 * (3 * 8 + 2 * 8) * 2 * 10 / 989e12 * 1e3)
    assert bytes_ms == pytest.approx(((2 * (64 + 32 + 32) + 2 * 64) * 2 + 4 * 2 * 4) / 3.35e12 * 1e3)


def test_wave_bounds_by_hand():
    assert A.cut_bound_ms(1000, 10, 2)[0] == pytest.approx((1000 + 40 + 24) / 3.35e12 * 1e3)
    nbytes_ms, ops_ms = A.fp_bound_ms(1000, 3, 128)
    assert nbytes_ms == pytest.approx((1000 + 48) / 3.35e12 * 1e3)
    assert ops_ms == pytest.approx(44 * 3 * 128 / (132 * 128 * 1.98e9) * 1e3)


def test_model_flops_by_hand():
    m = dict(n_layers=1, d_model=4, n_heads=2, n_kv_heads=1, head_dim=2, d_ff=8, vocab=250, n_frontend_tokens=1,
             seq_len=3, global_batch=1, accum=1)
    per_layer = 4 * 4 * 2 + 4 * 2 * 2 + 3 * 4 * 8
    # the vocabulary's 250 rows, not the 256 the program pads them to
    want = 6 * (per_layer * 3 + 4 * 250 * 2) + 3 * 2 * 4 * 2 * 6
    assert family("decoder").model_flop_per_step(m) == want
    m = dict(n_layers=1, d_model=2, vocab=250, ssm_expand=2, ssm_state=2, ssm_head_dim=2, ssm_chunk=2,
             seq_len=4, global_batch=1, accum=1)
    d_in, heads = 4, 2
    per_layer = 2 * (2 * d_in + 2 * 2 + heads) + d_in * 2
    ssd = 2 * (2 * 2 * 2 + 2 * 2 * heads * 2 + 2 * 2 * 2 * heads * 2) * 2
    assert family("mamba2").model_flop_per_step(m) == 6 * (per_layer * 4 + 2 * 250 * 4) + 3 * ssd


@pytest.mark.parametrize("shape", [(1, 4096, 32, 8, 128, True, 0), (1, 700, 40, 8, 128, True, 0),
                                   (2, 300, 4, 2, 64, True, 64), (1, 256, 4, 4, 32, False, 0)])
def test_flash_bounds_equal_chip_smoke(smoke, shape):
    b, s, h, kv, hd, causal, window = shape

    class T:
        def __init__(self, shp):
            self.shape = shp

        def numel(self):
            return math.prod(self.shape)

        def element_size(self):
            return 2

    q, k, v = T((b, s, h, hd)), T((b, s, kv, hd)), T((b, s, kv, hd))
    assert A.flash_bound_ms(q, k, v, causal, window) == smoke.flash_bound_ms(q, k, v, causal, window)
    assert A.flash_bwd_bound_ms(q, k, v, causal, window) == smoke.flash_bwd_bound_ms(q, k, v, causal, window)


@pytest.mark.parametrize("wave", [(975_220_736, 3726, 13), (4_341_137_412, 16_588, 45)])
def test_cut_bound_equals_chip_smoke(smoke, wave):
    assert A.cut_bound_ms(*wave) == smoke.cut_bound_ms(*wave)


def test_fingerprint_bound_states_its_change(smoke):
    """The operations bound equals chip_smoke.py's at its 44 operations a
    word; the bytes bound counts the wave's stream bytes, where chip_smoke.py
    counts the padded rows."""
    wave_bytes, rows, width = 4_341_137_412, 6537, 262_272
    ours = A.fp_bound_ms(wave_bytes, rows, width)
    theirs = smoke.fp_bound_ms(rows, width, 44)
    assert ours[1] == pytest.approx(theirs[1])
    assert ours[0] == pytest.approx((wave_bytes + 16 * rows) / 3.35e12 * 1e3)
    assert ours[0] < theirs[0]


def test_h100_peaks():
    assert A.BF16_FLOP_PER_S == 989e12 and A.HBM_BYTES_PER_S == 3.35e12
