"""The flash backward's CUDA source and its host-side choices, on the CPU.

The card runs ``tools/flash_planted_faults.py``: it builds mutants of
``csrc/flash_attn_bwd.cu`` (and of ``csrc/flash_attn.cu``) by text edits
and requires the check to fail each. Here each edit point is held to occur
in the source exactly as often as the tool expects, so a change to the
source that moves an edit point fails a test on the CPU instead of the
tool on the card. Also: the head split the wrapper picks
(``flash_attn.bwd_head_split``), that the build hash follows a shared
header, and that the bf16 backward is written in ``wgmma`` with no
``mma.sync``.
"""

import os
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import bwd_head_split, bwd_key_tile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import flash_planted_faults as faults  # noqa: E402

BWD_SRC = (_build.CSRC / "flash_attn_bwd.cu").read_text()
FWD_SRC = (_build.CSRC / "flash_attn.cu").read_text()


@pytest.mark.parametrize("name,edit", [(n, i) for n, edits in faults.BWD_MUTANTS.items() for i in range(len(edits))])
def test_each_backward_edit_point_occurs_once(name, edit):
    old, new = faults.BWD_MUTANTS[name][edit]
    assert BWD_SRC.count(old) == 1
    assert old != new


@pytest.mark.parametrize("name", list(faults.BWD_MUTANTS))
def test_each_backward_mutant_edits_the_source(name):
    mutant = faults.bwd_mutant_source(BWD_SRC, name)
    assert mutant != BWD_SRC
    assert len(mutant.splitlines()) - len(BWD_SRC.splitlines()) == sum(
        new.count("\n") - old.count("\n") for old, new in faults.BWD_MUTANTS[name])


def test_the_bf16_only_mutant_leaves_the_float32_kernels_alone():
    for name in faults.BWD_BF16_ONLY:
        for old, _ in faults.BWD_MUTANTS[name]:
            simt = BWD_SRC[BWD_SRC.index("flash_bwd_dkdv_simt("):BWD_SRC.index("bf16: wgmma + TMA")]
            assert old not in simt


@pytest.mark.parametrize("name", [*faults.TILE_MUTANTS, *faults.HD256_MUTANTS])
def test_each_forward_mutant_applies(name):
    assert faults.mutant_source(FWD_SRC, name) != FWD_SRC


def test_bf16_backward_is_wgmma_with_no_mma_sync():
    header = (_build.CSRC / "hopper.cuh").read_text()
    assert "mma.sync" not in BWD_SRC and "mma_bf16" not in BWD_SRC
    assert "wgmma.mma_async" in header and '#include "hopper.cuh"' in BWD_SRC
    for kernel in ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"):
        assert f"{kernel}<DQK, DV>" in BWD_SRC


# (B, Skv, K, H / K, dqk, SMs) -> head split: the train shapes of
# chip_smoke.TRAIN_ATTENTION_SHAPES on an H100's 132 SMs, then small ones.
@pytest.mark.parametrize("args,want", [
    ((1, 4096, 8, 4, 128, 132), 1),    # LLaVA-NeXT: 32 key tiles x 8 kv heads
    ((1, 4096, 8, 5, 128, 132), 1),    # Qwen2.5-32B
    ((1, 4096, 16, 1, 128, 132), 1),   # Qwen1.5-MoE
    ((1, 4096, 8, 2, 256, 132), 1),    # Gemma3-12B: 64-key tiles at hd 256
    ((1, 4096, 1, 10, 256, 132), 5),   # RecurrentGemma-2B: 64 blocks, 128 at 2, 320 at 5
    ((1, 4096, 40, 1, 96, 132), 1),    # MiniCPM3-4B
    ((2, 300, 1, 8, 128, 132), 8),     # too few blocks at any split: the whole group
    ((1, 100, 2, 1, 64, 132), 1),      # nothing to split
    ((1, 1000, 2, 6, 128, 16), 1),     # 8 key tiles x 2 kv heads: 16 blocks already
    ((1, 4096, 1, 10, 256, 100), 2),   # 64 blocks, 128 at a split of 2
])
def test_bwd_head_split(args, want):
    b, skv, kh, rep, dqk, sms = args
    got = bwd_head_split(b, skv, kh, rep, dqk, sms)
    assert got == want and rep % got == 0


def test_bwd_key_tile_matches_the_source():
    assert (bwd_key_tile(128), bwd_key_tile(96), bwd_key_tile(256)) == (128, 128, 64)
    assert "kKB = kSplitCols ? 64 : 128" in BWD_SRC and "kSplitCols = DQK > 128" in BWD_SRC


def test_build_hash_follows_an_included_header(tmp_path, monkeypatch):
    for f in ("flash_attn.cu", "flash_attn_bwd.cu", "fingerprint.cu", "hopper.cuh"):
        shutil.copy(_build.CSRC / f, tmp_path / f)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in ("flash_attn", "flash_attn_bwd", "fingerprint")}
    (tmp_path / "hopper.cuh").write_text((tmp_path / "hopper.cuh").read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in before}
    assert after["flash_attn"] != before["flash_attn"] and after["flash_attn_bwd"] != before["flash_attn_bwd"]
    assert after["fingerprint"] == before["fingerprint"]
