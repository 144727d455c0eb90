"""``chip_smoke.py``'s train phase 4b (LLaVA-NeXT-Mistral-7B) at a tiny size
on the CPU: its traffic (steps, save, node crash, scrub, restore,
ref-only re-save, resume) and the cut and fingerprint kernels' check on
the train state's wave, held against the twins (the CPU route is the
twin, so a wrong cut is planted to show the check fails it). Phases 4c and
4d are in ``tests/test_torch_train_families.py``.
"""

import dataclasses
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_to_tree
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the full-size train phase)


# ------------------------------------------------ the chip phase's traffic ---
def test_chip_smoke_train_traffic_on_cpu():
    """chip_smoke.py's train phase traffic (steps, save, crash, add_node,
    scrub, restore, ref-only re-save, resume) on reduced LLaVA-NeXT on the
    CPU: its own checks hold, and every save names its chunks with one
    launch pair."""
    cfg = dataclasses.replace(get_config(chip_smoke.TRAIN_ARCH).reduced(), attn_impl="dense", remat="full")
    model = build_model(cfg, device="cpu")
    n_front = cfg.n_frontend_tokens
    data = chip_smoke.PatchedLMData(SyntheticLMData(vocab=cfg.vocab, seq_len=48 - n_front, global_batch=2, seed=0),
                                    n_front, cfg.d_model, cfg.param_dtype, model.device, 0)
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 16 * 1024))
    ckpt = chip_smoke.TimedSaves(DedupCheckpointer(cluster, CheckpointConfig(fp_chunk_bytes=4096), device="cpu"),
                                 lambda: None)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state, line = chip_smoke.train_traffic(model, data, cluster, ckpt, opt, 0, lambda: None)
    assert [s["step"] for s in line["steps"]] == [0, 1, 2, 3]
    assert [s["ref_only"] for s in line["saves"]] == [0, 49, 0]
    assert line["restored_loss_step2"] == line["live_step2"]["total_loss"]
    assert int(state["opt"]["step"]) == 4


def _wave_check_on_cpu(monkeypatch):
    """chip_smoke.train_wave_check on reduced LLaVA-NeXT's train state, with
    the card's clock and syncs made no-ops (the CPU route is the twin)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "_timed", lambda fn, reps: (fn(), 0.0)[1])
    cfg = dataclasses.replace(get_config(chip_smoke.TRAIN_ARCH).reduced(), attn_impl="dense", remat="full")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0, AdamWConfig())
    spec = DedupCheckpointer(DedupCluster.create(4, replicas=2), CheckpointConfig(fp_chunk_bytes=4096),
                             device="cpu").spec
    return state, cfg, spec


def test_chip_smoke_train_wave_check_on_cpu(monkeypatch):
    """chip_smoke.py's kernel check at the train wave's shapes covers every
    leaf of the saved tree and builds one fingerprint row per chunk."""
    from repro_torch.kernels import ops

    state, cfg, spec = _wave_check_on_cpu(monkeypatch)
    got = chip_smoke.train_wave_check(state, cfg, spec, 44.0)
    streams = [ops.tensor_to_u8(leaf) for _, leaf in _leaf_paths(train_state_to_tree(state, cfg))]
    wave = ops.cdc_cut_and_fingerprint_many(streams, spec=spec)
    n_bytes = sum(int(s.numel()) for s in streams)
    m_cut = sum(int(r[0].numel()) for r in wave)
    n_chunks = sum(r[3] for r in wave)
    assert n_chunks < m_cut + len(wave)
    cut, fp = got["cdc_cut_positions_cuda"], got["fingerprint_chunks_cuda"]
    assert cut["shape"] == f"{len(streams)} streams, {n_bytes} B, {m_cut} cut slots"
    assert fp["shape"].startswith(f"({n_chunks}, ")
    assert (cut["mismatches"], cut["max_abs_err"], fp["mismatches"], fp["max_abs_err"]) == (0, 0, 0, 0)
    assert cut["bound_by"] == "bytes" and cut["bound_ms"] > 0 and fp["bound_ms"] > 0


def test_chip_smoke_train_wave_check_catches_a_wrong_cut(monkeypatch):
    """A cut kernel that is wrong but deterministic (one cut moved by a
    byte) fails the train wave's check, which a restore cannot show."""
    from repro_torch.kernels import cdc

    state, cfg, spec = _wave_check_on_cpu(monkeypatch)
    sound = cdc.cdc_cut_positions_cuda

    def moved(streams, **kw):
        out = sound(streams, **kw)
        pos, n_cuts, n_chunks = out[-1]
        assert n_cuts > 0
        pos = pos.clone()
        pos[0] -= 1
        return [*out[:-1], (pos, n_cuts, n_chunks)]

    monkeypatch.setattr(cdc, "cdc_cut_positions_cuda", moved)
    with pytest.raises(AssertionError, match="differ from the twin"):
        chip_smoke.train_wave_check(state, cfg, spec, 44.0)
