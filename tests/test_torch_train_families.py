"""``chip_smoke.py``'s train phases for the MoE and SSM families (4c:
Qwen1.5-MoE-A2.7B, 4d: Mamba2-1.3B) at a tiny size on the CPU, held
against the JAX package.

Each case runs ``chip_smoke.family_train_traffic`` on a reduced float32
model of the port: two steps in 2 microbatches whose hook saves step-2, an
identical re-save (all ref-only, 0 bytes sent) and a restore of step-2
(bitwise against the live state, the same loss on step 2's batch). The
same weights, drawn by the JAX package and carried across with
``train_state_from_tree``, go through the JAX package's ``train_loop`` with
its ``DedupCheckpointer`` (on the host path, as the JAX tests save on the
CPU). The two runs' losses, and every leaf of their final train states,
agree within 2e-4, the reference's float32 tolerance
(``tests/test_flash_attn_kernel.py:46``), and the JAX checkpointer's
restore of the port's step-2 is bitwise the port's state.
Mamba2's ``a_log`` is calmed as in ``tests/test_torch_mamba2.py``: the
reference's gradient is NaN where a masked decay overflows.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import repro.core as jcore
import repro_torch.core as tcore
from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import DedupCheckpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import init_train_state as jinit_train_state
from repro.train.loop import train_loop as jtrain_loop
from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_tree, train_state_to_tree
from repro_torch.optim import AdamWConfig

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phases 4c and 4d)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
TOL = 2e-4


def numpy_tree(tree):
    """A JAX tree as numpy leaves, bfloat16 as its uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, tree)


def calm(tree):
    """Every ``a_log`` of the parameters and the fp32 master (not the
    moments) at log(0.05..0.5), so that no masked decay overflows."""
    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] != "a_log" or {"mu", "nu", "err"} & set(keys):
            return x
        return jnp.broadcast_to(jnp.log(jnp.linspace(0.05, 0.5, x.shape[-1])), x.shape).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_family_train_traffic_matches_jax(arch):
    over = dict(attn_impl="dense", remat="full")
    jcfg = dataclasses.replace(jget_config(arch).reduced(), param_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=torch.float32, **over)
    jm = jbuild_model(jcfg)
    js0 = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    if arch == "mamba2-1.3b":
        js0 = calm(js0)
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=7)

    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 64 * 1024))
    ckpt = chip_smoke.TimedSaves(DedupCheckpointer(tc, device="cpu"), lambda: None)
    ts0 = train_state_from_tree(numpy_tree(js0), tcfg, device="cpu")
    ts, out = chip_smoke.family_train_traffic(build_model(tcfg, device="cpu"), data, tc, ckpt, AdamWConfig(**OPT),
                                              0, lambda: None, state=ts0)
    first, again = out["saves"]
    assert first["name"] == "step-2" and first["ref_only"] == 0 and first["bytes_sent"] > 0
    assert again["ref_only"] == again["leaves"] == first["leaves"] and again["bytes_sent"] == 0
    assert out["restored_loss_step2"] == out["live_step2"]["total_loss"]

    jc = jcore.DedupCluster.create(4, replicas=2, chunking=jcore.ChunkingSpec("fixed", 64 * 1024))
    jckpt = JCheckpointer(jc, JCheckpointConfig(device_fp_fastpath=False))
    tcfg_j = JTrainConfig(steps=2, accum=2, log_every=1, checkpoint_every=2, opt=JAdamWConfig(**OPT))
    js, jhist = jtrain_loop(jm, data, tcfg_j, checkpointer=jckpt, state=js0)
    assert [h["step"] for h in out["steps"]] == [h["step"] for h in jhist] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in out["steps"]], [h["loss"] for h in jhist], rtol=TOL, atol=TOL)
    assert jckpt.list_checkpoints() == ["step-2"]

    # the final states: step 1's update (what step-2 holds) as the reference's
    t_leaves = _leaf_paths(train_state_to_tree(ts, tcfg))
    j_final = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_final]
    for (key, t), (_, j) in zip(t_leaves, j_final):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL, atol=TOL, err_msg=key)

    # the JAX checkpointer restores the port's step-2 as the port's state
    restored = JCheckpointer(tc).restore("step-2", like=js0)
    j_leaves = jax.tree_util.tree_flatten_with_path(restored)[0]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert np.array_equal(_bytes(t), _bytes(j)), key


class _Event:
    """A profiler event's name, parent and input shapes."""

    def __init__(self, name, shapes=(), parent=None):
        self.name, self.input_shapes, self.cpu_parent = name, [list(x) for x in shapes], parent


def _category(cats, shapes, name: str = "aten::bmm") -> str:
    return chip_smoke.op_category(_Event(name, shapes), cats)


@pytest.mark.parametrize("arch,cases", [
    ("qwen2-moe-a2.7b", [
        ([(4096, 2048), (2048, 60)], "moe router (product, softmax, top-k)"),
        ([(4096, 60)], "moe router (product, softmax, top-k)"),
        ([(16, 256, 1320), (16, 256, 4)], "moe dispatch and combine (scatters, one-hot products)"),
        ([(16, 1320, 256), (16, 256, 2048)], "moe dispatch and combine (scatters, one-hot products)"),
        ([(16, 1024, 60)], "moe dispatch and combine (scatters, one-hot products)"),
        ([(60, 352, 2048), (60, 2048, 1408)], "moe experts (einsums)"),
        ([(16, 60, 22, 1408)], "moe experts (einsums)"),
        ([(4096, 2048), (2048, 151936)], "unembedding and loss"),
        ([(16, 4096, 4096), (16, 4096, 128)], "attention (dense scores)"),
        ([(1, 16, 1, 4096, 4096)], "attention (dense scores)"),
        ([(4096, 2048), (2048, 2048)], "other"),
        ([(4096, 2048), (2048, 5632)], "other"),
        # a leading dim of E alone is no expert operand
        ([(60, 4096, 2048)], "other"),
        ([(24, 60, 2048, 1408)], "moe experts (einsums)"),
    ]),
    ("mamba2-1.3b", [
        ([(1, 64, 1, 1), (1, 64, 128, 64)], "ssd chunk loop (B, H, N, P) state"),
        ([(1, 32, 128, 128, 64)], "ssd within-chunk (B, NC, Q, Q, H) weights"),
        ([(2048, 128, 128), (2048, 128, 64)], "ssd within-chunk (B, NC, Q, Q, H) weights"),
        ([(1, 32, 64, 128, 64)], "ssd other fp32 passes (chunk states, read-out)"),
        ([(1, 32, 128, 64, 64)], "ssd other fp32 passes (chunk states, read-out)"),
        # a 5-D tensor of other dims is no SSD pass
        ([(1, 2, 3, 4, 5)], "other"),
        ([(4096, 2048), (2048, 50280)], "unembedding and loss"),
        ([(4096, 2048), (2048, 8512)], "other"),
        ([(1, 4096, 4352), (1, 4096, 4352)], "other"),
    ]),
])
def test_step_categories_name_each_family_operation(arch, cases):
    """``chip_smoke.step_categories`` at full width tells a train step's
    operations apart by their input shapes: each family's own operations
    go to their category, the projections and tensors that only share a
    dim with them to "other"."""
    cats = chip_smoke.step_categories(get_config(arch))
    for shapes, want in cases:
        assert _category(cats, shapes) == want, shapes
    # an elementwise operation on two (B, S, D) tensors is no attention
    assert _category(cats, [(1, 4096, 2048), (1, 4096, 2048)], "aten::add") == "other"


def test_input_shapes_flatten_tensor_lists():
    assert chip_smoke._input_shapes([[2, 3], [], [[1, 4], [1, 4]], 5]) == [(2, 3), (1, 4), (1, 4)]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_op_category_takes_embedding_and_optimizer_by_ancestor(arch):
    """The embedding's gather and its backward's ``_index_put_impl_``, whose
    table has the unembedding's (V, D) shape, and every operation of the
    optimizer's update are told by their ancestors (an operation under
    them, of any shape, is theirs); the unembedding's product by its own
    shapes."""
    cfg = get_config(arch)
    cats = chip_smoke.step_categories(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    gather = _Event("aten::index", [(v, d), (1, 4096)])
    backward = _Event("aten::sort", [(4096,)],
                      _Event("aten::_index_put_impl_", [(v, d), (4096,), (4096, d)], _Event("IndexBackward0")))
    update = _Event("aten::_foreach_mul_", [(v, d)], _Event("aten::mul", [(v, d)], _Event("adamw_update")))
    unembed = _Event("aten::mm", [(4096, d), (d, v)], _Event("aten::matmul"))
    # an index into another tensor is no embedding
    other_index = _Event("aten::index", [(4096, 64), (4096,)])
    assert chip_smoke.op_category(gather, cats) == chip_smoke.op_category(backward, cats) == \
        "embedding (gather, its backward)"
    assert chip_smoke.op_category(update, cats) == "optimizer (adamw_update)"
    assert chip_smoke.op_category(unembed, cats) == "unembedding and loss"
    assert chip_smoke.op_category(other_index, cats) == "other"


def test_train_wave_check_names_the_longest_stream(monkeypatch):
    """The train wave's check holds the twins on every stream and names the
    longest one (the embedding's fp32 leaves at full width)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "_timed", lambda fn, reps: (fn(), 0.0)[1])
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.kernels import ops
    from repro_torch.train.loop import init_train_state

    # one layer and a small vocabulary: the twins' int64 work scales with the state
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(), param_dtype=torch.float32, n_layers=1, vocab=64)
    state = init_train_state(build_model(cfg, device="cpu"), 0, AdamWConfig(**OPT))
    spec = DedupCheckpointer(DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 64 * 1024)),
                             CheckpointConfig(fp_chunk_bytes=4096), device="cpu").spec
    got = chip_smoke.train_wave_check(state, cfg, spec, 44.0)
    streams = [ops.tensor_to_u8(leaf) for _, leaf in _leaf_paths(train_state_to_tree(state, cfg))]
    longest = max(int(s.numel()) for s in streams)
    assert got["cdc_cut_positions_cuda"]["longest_stream_bytes"] == longest
    for name in ("cdc_cut_positions_cuda", "fingerprint_chunks_cuda"):
        assert (got[name]["mismatches"], got[name]["max_abs_err"]) == (0, 0)
        assert got[name]["plain_ms"] > 0 and got[name]["bound_ms"] > 0
