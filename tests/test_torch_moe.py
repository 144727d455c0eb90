"""The port's mixture-of-experts models (reduced Qwen1.5-MoE-A2.7B and
Llama-4-Scout) held against the JAX package's, on the CPU.

The JAX side builds the parameters and the same values reach the port
through ``params_from_numpy`` (or its train-state twin); inputs come from
seeded numpy. Expert ids must be equal; outputs agree within the
reference's tolerances: 2e-4 with float32 parameters, 3e-2 with bfloat16
ones (``tests/test_flash_attn_kernel.py:46,58``).
"""

import dataclasses
import functools
import os
import re
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
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.loop import build_train_step as jbuild_train_step
from repro.train.loop import init_train_state as jinit_train_state
from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.models.convert import (
    _tree_of_named,
    params_from_numpy,
    params_to_numpy,
    train_state_from_tree,
    train_state_to_tree,
)
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop
from repro_torch.train.loop import build_train_step, init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 9's traffic)

ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def numpy_tree(tree):
    """A JAX tree as numpy leaves, bfloat16 as its uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, dtype):
    np.testing.assert_allclose(_np(a), _np(b), rtol=TOL[dtype], atol=TOL[dtype])


def _cfgs(arch: str, dtype: str = "float32", **overrides):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=_TORCH[dtype], **overrides)
    return jcfg, tcfg


def pair(arch: str, dtype: str = "float32", seed: int = 0, **overrides):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jcfg, tcfg = _cfgs(arch, dtype, **overrides)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(numpy_tree(jp), tcfg, device="cpu")


def _tokens(seed: int, shape, vocab: int):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _flat(tree):
    """Leaves of a (JAX or port) cache tree in the JAX flattening order."""
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


# ------------------------------------------------------- routing and FFN ---
def _moe_pair(arch: str, dtype: str, seed: int = 0, **overrides):
    """Layer 0's MoE parameters in both packages, and the two specs."""
    jm, jp, tm, tp = pair(arch, dtype, seed, **overrides)
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["moe"])
    return jT._moe_spec(jm.cfg), jparams, tT._moe_spec(tm.cfg), tp.blocks[0].moe


def _x(seed: int, shape, dtype: str):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(_JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def test_routing_ties_take_the_lower_expert_first():
    """Crafted ties at and around the k-th place: token i's router logits
    are row i of the router weight (one-hot inputs), so the ties are exact.
    jax.lax.top_k takes the lower index first; so must the port."""
    jspec, jp, tspec, tp = _moe_pair("qwen2-moe-a2.7b", "float32")
    e, d = tspec.n_experts, tspec.d_model          # 4 experts, top-2
    rows = np.array([[0, 0, 0, 0], [1, 2, 2, 2], [2, 1, 1, 2], [0, 3, 0, 3], [5, 5, 1, 5]], np.float32)
    w = np.zeros((d, e), np.float32)
    w[: len(rows)] = rows
    x = np.eye(len(rows), d, dtype=np.float32)
    jp = dict(jp, router={"w": jnp.asarray(w)})
    with torch.no_grad():
        tp.router.w.copy_(torch.from_numpy(w))
    jids, jw, _ = jmoe._routing(jp, jspec, jnp.asarray(x))
    tids, tw, _ = tmoe._routing(tp, tspec, torch.from_numpy(x))
    want = [[0, 1], [1, 2], [0, 3], [1, 3], [0, 1]]
    np.testing.assert_array_equal(np.asarray(jids), want)
    np.testing.assert_array_equal(tids.numpy(), want)
    _close(tw, jw, "float32")


@pytest.mark.parametrize("arch,capacity_factor,drops", [
    ("qwen2-moe-a2.7b", 16.0, False), ("qwen2-moe-a2.7b", 0.5, True), ("llama4-scout-17b-a16e", 0.5, True),
])
def test_routing_and_moe_ffn_match_jax(arch, capacity_factor, drops):
    """``_routing`` (expert ids equal, weights and aux loss) and ``moe_ffn``
    on 96 tokens in groups of 32 (moe_group 64 halved to a divisor of 96);
    at capacity factor 0.5 an expert keeps fewer slots than it is chosen,
    so later choices are dropped, as in the reference."""
    jspec, jp, tspec, tp = _moe_pair(arch, "float32", capacity_factor=capacity_factor, moe_group=64)
    jx, tx = _x(2, (2, 48, tspec.d_model), "float32")
    (jids, jw, jaux), (jy, jaux2) = jax.jit(
        lambda p, x: (jmoe._routing(p, jspec, x.reshape(96, -1)), jmoe.moe_ffn(p, jspec, x)))(jp, jx)
    tids, tw, taux = tmoe._routing(tp, tspec, tx.reshape(96, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw, "float32")
    _close(taux, jaux, "float32")
    ty, taux2 = tmoe.moe_ffn(tp, tspec, tx)
    _close(ty, jy, "float32")
    _close(taux2, jaux2, "float32")
    g = tmoe.group_size(tspec, 96)
    assert g == 32
    _, keep = tmoe.dispatch_slots(tspec, tids, g)
    assert bool(keep.all()) != drops


def test_dispatch_slots_count_in_token_major_order():
    """Expert 1 is chosen three times (token 0's choice 0, token 1's choice
    1, token 2's choice 0) and holds 2 slots: its third pair in token-major
    order is dropped. A slot is expert * C + position."""
    spec = tmoe.MoESpec(d_model=8, n_experts=3, top_k=2, expert_d_ff=4, capacity_factor=1.0)
    ids = torch.tensor([[1, 0], [2, 1], [1, 2]])  # g = 3, cap = ceil(2 * 3 / 3) = 2
    slot, keep = tmoe.dispatch_slots(spec, ids, 3)
    assert keep.tolist() == [[[True, True], [True, True], [False, True]]]
    assert slot.tolist() == [[[2, 0], [4, 3], [3, 5]]]


def test_moe_ffn_bf16_ids_and_outputs():
    """bfloat16: the router's bf16 product may flip a near-tie, so ids must
    agree on >= 99 % of (token, choice) pairs, and tokens whose ids all
    agree must agree within 3e-2 (no drops, so other tokens' flips do not
    move them)."""
    jspec, jp, tspec, tp = _moe_pair("qwen2-moe-a2.7b", "bfloat16", capacity_factor=16.0, moe_group=64)
    jx, tx = _x(3, (2, 128, tspec.d_model), "bfloat16")
    jids, jy = jax.jit(lambda p, x: (jmoe._routing(p, jspec, x.reshape(256, -1))[0], jmoe.moe_ffn(p, jspec, x)[0]))(
        jp, jx)
    tids, _, _ = tmoe._routing(tp, tspec, tx.reshape(256, -1))
    same = tids.numpy() == np.asarray(jids)
    assert same.mean() >= 0.99
    rows = same.all(axis=1)
    ty, _ = tmoe.moe_ffn(tp, tspec, tx)
    _close(ty.reshape(256, -1)[torch.from_numpy(rows)], np.asarray(jy, np.float32).reshape(256, -1)[rows], "bfloat16")


# ----------------------------------------------------------- full models ---
@pytest.mark.parametrize("arch,dtype,attn_impl", [
    ("qwen2-moe-a2.7b", "float32", "chunked"), ("qwen2-moe-a2.7b", "bfloat16", "chunked"),
    ("llama4-scout-17b-a16e", "float32", "dense"),
])
def test_prefill_and_decode_match_jax(arch, dtype, attn_impl):
    """A 24-token prefill into 28-slot caches and 2 decode steps at
    capacity factor 16 (no drops, so a bf16 id flip moves one token only):
    the logits, and every cache leaf. In bfloat16 the router's bf16
    product flips a near-tie now and then (1 of 96 (token, choice) pairs a
    layer at this seed), which moves that token's FFN output by more than
    3e-2 an element; there the cache leaves compared are layer 0's and the
    logits are held by relative max error, within 0.05."""
    jm, jp, tm, tp = pair(arch, dtype, capacity_factor=16.0, attn_impl=attn_impl, attn_q_chunk=8, attn_kv_chunk=8)
    toks = _tokens(0, (2, 24), tm.cfg.vocab)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, {"tokens": jnp.asarray(toks)}, 28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=28)
    assert tl.shape == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    check_logits(tl, jl, dtype)
    assert [tuple(t.shape) for t in _flat(tc)] == [tuple(j.shape) for j in _flat(jc)]

    def check_caches():
        pairs = zip(_flat(tc), _flat(jc)) if dtype == "float32" else \
            ((tc[0][0][n][0], jc[0][0][n][0]) for n in tc[0][0])
        for t, j in pairs:
            _close(t, j, dtype)

    check_caches()
    jdecode = jax.jit(jm.decode_step)
    for pos in (24, 25):
        nxt = _tokens(pos, (2, 1), tm.cfg.vocab)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        check_logits(tl, jl, dtype)
    check_caches()


def check_logits(t, j, dtype):
    if dtype == "float32":
        _close(t, j, dtype)
        return
    a, b = _np(t), _np(j)
    assert np.abs(a - b).max() / np.abs(b).max() < 0.05


def test_moe_consistency_without_capacity_drops():
    """tests/test_models.py's check on the port: at capacity factor 16, 8
    decode steps after a 16-token prefill give the last logits of a fresh
    24-token prefill."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), capacity_factor=16.0)
    m = build_model(cfg, device="cpu")
    params = m.init(1)
    toks = torch.from_numpy(_tokens(0, (2, 24), cfg.vocab))
    _, caches = m.prefill(params, {"tokens": toks[:, :16]}, cache_len=24)
    lg = None
    for t in range(16, 24):
        lg, caches = m.decode_step(params, caches, toks[:, t : t + 1], t)
    ref, _ = m.prefill(params, {"tokens": toks}, cache_len=24)
    a, b = lg[:, 0].float(), ref[:, 0].float()
    assert float((a - b).abs().max() / (b.abs().max() + 1e-6)) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    specs = build_model(tcfg, device="cpu").cache_specs(ShapeSpec("d", 48, 2, "decode"))
    jspecs = jbuild_model(jcfg).cache_specs(JShapeSpec("d", 48, 2, "decode"))
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tT.TensorSpec))
    assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in tleaves] == \
        [(j.shape, j.dtype.name) for j in jleaves]


# ------------------------------------------------------- loss and grads ---
def _batch(cfg, seed: int, batch: int = 2, seq: int = 24) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    out["labels"][:, :3] = -1
    return out


@pytest.mark.parametrize("arch,dtype,remat", [
    ("qwen2-moe-a2.7b", "float32", "dots"), ("llama4-scout-17b-a16e", "float32", "full"),
])
def test_loss_fn_and_grads_match_jax(arch, dtype, remat):
    """The total loss (LM loss + 0.01 x the summed aux loss), the aux loss,
    and every parameter's gradient, router and experts included; under
    ``remat="dots"`` the batched expert products are recomputed in both
    packages."""
    jm, jp, tm, tp = pair(arch, dtype, remat=remat)
    batch = _batch(tm.cfg, 1)
    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(tp.named_parameters())
    grads = _tree_of_named(dict(zip(named, torch.autograd.grad(total, list(named.values())))), tm.cfg)
    _close(total, jtotal, dtype)
    _close(met["aux_loss"], jmet["aux_loss"], dtype)
    t_leaves = _leaf_paths(grads)
    j_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), key
        _close(t, j, dtype)


# ------------------------------------------------------ parameter trees ---
@pytest.mark.parametrize("weight_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, weight_quant):
    jcfg, tcfg = _cfgs(arch, "bfloat16", weight_quant=weight_quant)
    tree = numpy_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(5)))
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_jax_tree(arch):
    """The port's own init builds the tree the JAX package builds: same
    keys, shapes and dtypes (stacked (G, E, D, F) experts, the shared FFN)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = params_to_numpy(build_model(tcfg, device="cpu").init(0), tcfg)
    jspec = jbuild_model(jcfg).param_specs()
    flat_t, def_t = jax.tree.flatten(tree)
    flat_j, def_j = jax.tree.flatten(jspec)
    assert def_t == def_j
    for t, j in zip(flat_t, flat_j):
        assert t.shape == j.shape
        assert t.dtype == (np.uint16 if j.dtype == jnp.bfloat16 else j.dtype)


def test_train_state_tree_round_trip_and_leaf_keys():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "bfloat16")
    js = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0), JAdamWConfig(**OPT, compress_grads=True))
    back = train_state_to_tree(train_state_from_tree(numpy_tree(js), tcfg, device="cpu"), tcfg)
    t_leaves = _leaf_paths(back)
    j_leaves = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        t = t.detach().reshape(-1)
        t = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().view(np.uint8)
        assert np.array_equal(t, np.asarray(j).reshape(-1).view(np.uint8)), key


# ---------------------------------- train checkpoints across the packages ---
def _jax_steps(step, js, data, steps):
    met = None
    for i in steps:
        js, met = step(js, {k: jnp.asarray(v) for k, v in data.batch(i).items()})
    return js, met


def _assert_state_close(ts, js, cfg):
    t_leaves = _leaf_paths(train_state_to_tree(ts, cfg))
    j_leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(js))[0]
    assert len(t_leaves) == len(j_leaves)
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        _close(t, j, "float32")


@functools.cache
def _jax_train():
    """The reduced Qwen1.5-MoE's JAX model and its jitted train step, built
    once for both resume tests."""
    jm = jbuild_model(_cfgs("qwen2-moe-a2.7b")[0])
    return jm, jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT)))


def test_jax_moe_checkpoint_resumes_in_the_port():
    tcfg = _cfgs("qwen2-moe-a2.7b")[1]
    (jm, step), tm = _jax_train(), build_model(tcfg, device="cpu")
    js = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=3)
    js, _ = _jax_steps(step, js, data, range(2))
    jc = jcore.DedupCluster.create(4, replicas=2, chunking=jcore.ChunkingSpec("fixed", 64 * 1024))
    # the host path: the JAX package's device path runs its Pallas kernels
    # interpreted here
    JCheckpointer(jc, JCheckpointConfig(device_fp_fastpath=False)).save("step-2", js)
    js3, jmet = _jax_steps(step, js, data, [2])
    like = train_state_to_tree(init_train_state(tm, 9, AdamWConfig(**OPT)), tcfg)
    ts = train_state_from_tree(DedupCheckpointer(jc, device="cpu").restore("step-2", like=like), tcfg, device="cpu")
    assert int(ts["opt"]["step"]) == 2
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, {k: torch.from_numpy(v) for k, v in data.batch(2).items()})
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_state_close(ts3, js3, tcfg)


def test_port_moe_checkpoint_resumes_in_jax():
    tcfg = _cfgs("qwen2-moe-a2.7b")[1]
    (jm, step), tm = _jax_train(), build_model(tcfg, device="cpu")
    js0 = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    ts = train_state_from_tree(numpy_tree(js0), tcfg, device="cpu")
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=4)
    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 64 * 1024))
    ts, _ = train_loop(tm, data, TrainConfig(steps=2, checkpoint_every=2, opt=AdamWConfig(**OPT)),
                       checkpointer=DedupCheckpointer(tc, device="cpu"), state=ts)
    jstate = JCheckpointer(tc).restore("step-2", like=js0)
    js3, jmet = _jax_steps(step, jstate, data, [2])
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, {k: torch.from_numpy(v) for k, v in data.batch(2).items()})
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_state_close(ts3, js3, tcfg)


# ------------------------------------------------------------- launcher ---
def test_train_launcher_prints_the_jax_lines(capsys, monkeypatch):
    """The launcher's step lines equal the reference's up to the losses and
    seconds (the checkpoint lines are held in test_torch_train.py)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--arch", "qwen2-moe-a2.7b", "--steps", "4", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    mask = lambda text: [re.sub(r"\d+\.\d+", "#", line) for line in text.splitlines()]
    assert mask(got) == mask(want) == ["step     0 loss # (#s)", "step     3 loss # (#s)"]


# ------------------------------------------------ chip_smoke.py phase 9 ---
def test_chip_smoke_moe_traffic_on_cpu():
    """chip_smoke.py's phase-9 MoE traffic at a tiny size on the CPU: the
    prefill at the config's capacity factor, decode, the fresh prefills at
    capacity factor 16 it is held against (as routed and with the
    traffic's routing replayed) with the expert ids of both, the layer-0
    drop share and the CPU-vs-CPU layer-0 check."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), attn_impl="chunked", moe_group=16)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(_tokens(6, (1, 40), cfg.vocab)).long()
    out = chip_smoke.moe_traffic(model, params, tokens, 32, 40)
    assert out["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}
    assert out["decode_vs_prefill_rel_err"] < 0.05 and out["decode_vs_replayed_prefill_rel_err"] < 0.05
    assert out["last_token_expert_ids_differ"] == 0 and out["expert_id_rows"] == cfg.n_layers * 40
    assert out["last_token_expert_ids"] == cfg.n_layers * cfg.top_k
    share = chip_smoke.moe_drop_share(params, cfg, tokens[:, :32])
    assert 0.0 <= share < 1.0
    check = chip_smoke.moe_layer0_check(params, cfg, tokens[:, :16])
    assert check["expert_ids_equal"] and check["max_abs_err"] == 0.0
