"""The port's training slice held against the JAX package's, on the CPU.

Reduced Qwen2.5-32B and reduced LLaVA-NeXT-Mistral-7B (with the vision
stub's ``patch_embeds``): the JAX side builds the train state
(``init_train_state`` from a PRNG key) and the same values reach the port
through ``train_state_from_tree``; batches come from seeded numpy. Losses,
grads, AdamW updates and train steps must agree within the reference's
tolerances: 2e-4 with float32 parameters, 3e-2 with bfloat16 ones
(``tests/test_flash_attn_kernel.py:46,58``). The twins of
``tests/test_train_ckpt.py`` run the same checks on the port alone, and a
train checkpoint written by either package resumes in the other.
"""

import dataclasses
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import repro.core as jcore
import repro_torch.core as tcore
from repro.checkpoint import DedupCheckpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.model import lm_loss as jlm_loss
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.train.loop import build_train_step as jbuild_train_step
from repro.train.loop import init_train_state as jinit_train_state
from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster, TransactionAbort, WriteError
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.convert import _tree_of_named, params_tree, train_state_from_tree, train_state_to_tree
from repro_torch.models.model import lm_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import TrainConfig, train_loop
from repro_torch.train.loop import build_train_step, init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the full-size train phase: its traffic)

ARCHS = {"qwen": "qwen2.5-32b", "llava": "llava-next-mistral-7b"}
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CH = ChunkingSpec("fixed", 64 * 1024)
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


def _cfgs(arch: str, dtype: str, **overrides):
    jcfg = dataclasses.replace(jget_config(ARCHS[arch]).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(ARCHS[arch]).reduced(), param_dtype=_TORCH[dtype], **overrides)
    return jcfg, tcfg


def _states(arch: str, dtype: str = "float32", seed: int = 0, opt=OPT, **overrides):
    """(JAX model, JAX state, port model, port state) with equal values."""
    jcfg, tcfg = _cfgs(arch, dtype, **overrides)
    jm = jbuild_model(jcfg)
    js = jinit_train_state(jm, jax.random.PRNGKey(seed), JAdamWConfig(**opt))
    tm = build_model(tcfg, device="cpu")
    return jm, js, tm, train_state_from_tree(numpy_tree(js), tcfg, device="cpu")


def _batch(cfg, seed: int, batch: int = 2, seq: int = 24, ignore: bool = False) -> dict:
    """Seeded tokens and labels (some ignored), plus the vision stub's
    float32 patch embeddings for a ``vision_stub`` config."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if ignore:
        out["labels"][:, :3] = -1
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads_tree(tm, tp, batch):
    """The port's loss, metrics and grads (as the JAX parameter tree)."""
    total, metrics = tm.loss_fn(tp, _torch(batch))
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()))
    return total.detach(), metrics, _tree_of_named(dict(zip(named, grads)), tm.cfg)


def _assert_trees_close(t_tree, j_tree, dtype):
    t_leaves = _leaf_paths(t_tree)
    j_leaves = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), key
        _close(t, j, dtype)


def _bits(x) -> np.ndarray:
    """A tensor's or array's bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _dtype(x) -> str:
    """A leaf's dtype name; a numpy tree holds bfloat16 as uint16 bits."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    name = np.asarray(x).dtype.name
    return "bfloat16" if name == "uint16" else name


# ------------------------------------------------------------- lm_loss ---
@pytest.mark.parametrize("case", ["plain", "padded_vocab", "ignored_labels", "all_ignored"])
def test_lm_loss_matches_jax(case):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    labels = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    vocab = 200 if case == "padded_vocab" else 0
    if case == "ignored_labels":
        labels[0, :2] = -1
        labels[1, 4] = -100
    if case == "all_ignored":
        labels[:] = -1
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, tot = lm_loss(lt, torch.from_numpy(labels), vocab)
    (dl,) = torch.autograd.grad(loss, lt)
    loss = loss.detach()
    (jloss, jtot), jdl = jax.value_and_grad(lambda x: jlm_loss(x, jnp.asarray(labels), vocab), has_aux=True)(
        jnp.asarray(logits))
    _close(loss, jloss, "float32")
    assert float(tot) == float(jtot)
    _close(dl, jdl, "float32")
    if case == "padded_vocab":
        assert float(dl[..., vocab:].abs().max()) == 0.0
    if case == "all_ignored":
        assert float(loss) == 0.0 and float(tot) == 1.0


# -------------------------------------------------- loss_fn and its grads ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen", "llava"])
def test_loss_fn_and_grads_match_jax(arch, dtype):
    jm, js, tm, ts = _states(arch, dtype)
    batch = _batch(tm.cfg, 1, ignore=True)
    (jtotal, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(js["params"], _jax(batch))
    total, met, grads = _grads_tree(tm, ts["params"], batch)
    _close(total, jtotal, dtype)
    _close(met["loss"], jmet["loss"], dtype)
    assert float(met["tokens"]) == float(jmet["tokens"]) == batch["tokens"].size - 6
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    _assert_trees_close(grads, jgrads, dtype)


def test_loss_fn_takes_text_positions_only():
    """With patch_embeds the loss covers the text positions: the frontend's
    positions are sliced off before the logits."""
    _, _, tm, ts = _states("llava")
    batch = _batch(tm.cfg, 2)
    total, met = tm.loss_fn(ts["params"], _torch(batch))
    assert float(met["tokens"]) == batch["labels"].size
    assert math.isfinite(float(total))


# --------------------------------------------------------------- AdamW ---
@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax_after_3_updates(compress):
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=5, compress_grads=compress)
    rng = np.random.default_rng(4)
    host = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal((48,)).astype(np.float32)}
    jparams = {"w": jnp.asarray(host["w"]), "b": jnp.asarray(host["b"]).astype(jnp.bfloat16)}
    tparams = {"w": torch.from_numpy(host["w"].copy()), "b": torch.from_numpy(host["b"]).to(torch.bfloat16)}
    jstate = jadamw_init(jparams, JAdamWConfig(**opt))
    tstate = adamw_init(tparams, AdamWConfig(**opt))
    assert sorted(tstate) == sorted(jstate)
    for i in range(3):
        # the first step's grads clip (norm ~ 80), the others do not
        scale = 1.0 if i == 0 else 0.01
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in host.items()}
        jparams, jstate, jmet = jadamw_update(jparams, _jax(grads), jstate, JAdamWConfig(**opt))
        tparams, tstate, tmet = adamw_update(tparams, _torch(grads), tstate, AdamWConfig(**opt))
        for k in ("grad_norm", "lr"):
            _close(tmet[k], jmet[k], "float32")
    assert int(tstate["step"]) == int(jstate["step"]) == 3 and tstate["step"].dtype == torch.int32
    for tree in ("master", "mu", "nu") + (("err",) if compress else ()):
        for k in host:
            _close(tstate[tree][k], jstate[tree][k], "float32")
    _close(tparams["w"], jparams["w"], "float32")
    assert tparams["b"].dtype == torch.bfloat16
    _close(tparams["b"], jparams["b"], "bfloat16")


def test_adamw_master_does_not_alias_float32_params():
    p = {"w": torch.ones(4)}
    state = adamw_init(p, AdamWConfig())
    assert state["master"]["w"].data_ptr() != p["w"].data_ptr()


# ---------------------------------------------------------- train step ---
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen", "llava"])
def test_train_step_matches_jax(arch, accum):
    jm, js, tm, ts = _states(arch)
    batch = _batch(tm.cfg, 5, batch=4)
    js2, jmet = jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT), accum))(js, _jax(batch))
    ts2, tmet = build_train_step(tm, AdamWConfig(**OPT), accum)(ts, _torch(batch))
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        _close(tmet[k], jmet[k], "float32")
    _assert_trees_close(train_state_to_tree(ts2, tm.cfg), jax.device_get(js2), "float32")


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_remat_modes_give_the_jax_loss_and_grads(remat):
    jm, js, tm, ts = _states("qwen", remat=remat)
    batch = _batch(tm.cfg, 6)
    (jtotal, _), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(js["params"], _jax(batch))
    total, _, grads = _grads_tree(tm, ts["params"], batch)
    _close(total, jtotal, "float32")
    _assert_trees_close(grads, jgrads, "float32")


def test_remat_modes_recompute_what_they_name():
    """Backward FLOPs: "none" recomputes nothing, "dots" recomputes the
    batched attention products but keeps the weight matmuls, "full"
    recomputes the whole forward of each group."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = {}
    for remat in ("none", "dots", "full"):
        _, _, tm, ts = _states("qwen", remat=remat)
        total, _ = tm.loss_fn(ts["params"], _torch(_batch(tm.cfg, 6)))
        with FlopCounterMode(display=False) as counter:
            torch.autograd.grad(total, list(ts["params"].parameters()))
        flops[remat] = counter.get_total_flops()
    assert flops["none"] < flops["dots"] < flops["full"], flops


# ------------------------------------- twins of tests/test_train_ckpt.py ---
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_config("qwen2.5-32b").reduced()
    model = build_model(cfg, device="cpu")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    return cfg, model, data


def _params(model, cfg, seed=0):
    return params_tree(model.init(seed), cfg)


def _assert_bitwise(a_tree, b_tree):
    a, b = _leaf_paths(a_tree), _leaf_paths(b_tree)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert _dtype(x) == _dtype(y) and tuple(x.shape) == tuple(np.shape(y))
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_loss_decreases(tiny_setup):
    cfg, model, data = tiny_setup
    tc = TrainConfig(steps=25, log_every=1,
                     opt=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=25))
    state, hist = train_loop(model, data, tc)
    first = np.mean([h["loss"] for h in hist[:4]])
    last = np.mean([h["loss"] for h in hist[-4:]])
    assert last < first - 0.1, (first, last)


def test_grad_accum_matches_full_batch(tiny_setup):
    cfg, model, data = tiny_setup
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state1 = init_train_state(model, 0, opt)
    state2 = init_train_state(model, 0, opt)
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    s1, _ = build_train_step(model, opt, accum=1)(state1, batch)
    s2, _ = build_train_step(model, opt, accum=2)(state2, batch)
    for a, b in zip(s1["params"].parameters(), s2["params"].parameters()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)


def test_gradient_compression_error_feedback():
    opt = AdamWConfig(lr=1e-2, compress_grads=True, warmup_steps=1, total_steps=5)
    params = {"w": torch.ones((64, 64), dtype=torch.float32)}
    before = params["w"].clone()
    state = adamw_init(params, opt)
    grads = {"w": torch.full((64, 64), 1e-3, dtype=torch.float32)}
    p2, s2, m = adamw_update(params, grads, state, opt)
    assert "err" in s2 and float(torch.sum(torch.abs(s2["err"]["w"]))) >= 0.0
    assert not torch.equal(p2["w"], before)
    # error feedback: non-uniform grads leave quantization residuals that
    # accumulate instead of vanishing (uniform tensors quantize losslessly)
    tiny = {"w": torch.from_numpy(np.random.default_rng(0).normal(0, 1e-6, (64, 64)).astype(np.float32))}
    _, s3, _ = adamw_update(p2, tiny, s2, opt)
    assert float(s3["err"]["w"].abs().max()) > 0


def test_checkpoint_roundtrip_bitexact(tiny_setup):
    cfg, model, data = tiny_setup
    state = train_state_to_tree(init_train_state(model, 3, AdamWConfig()), cfg)
    ck = DedupCheckpointer(DedupCluster.create(4, replicas=2, chunking=CH), device="cpu")
    ck.save("s1", state)
    restored = ck.restore("s1", like=state)
    _assert_bitwise(state, restored)


def test_checkpoint_dedup_across_saves(tiny_setup):
    cfg, model, data = tiny_setup
    params = _params(model, cfg)
    ck = DedupCheckpointer(DedupCluster.create(4, chunking=CH), device="cpu")
    ck.save("a", params)
    ck.save("b", params)  # identical -> ref-only writes, ~50% savings
    assert ck.stats["leaves_ref_only"] > 0
    assert ck.cluster.space_savings() > 0.45
    _assert_bitwise(ck.restore("a", like=params), ck.restore("b", like=params))


def test_checkpoint_delete_keeps_referenced_chunks(tiny_setup):
    cfg, model, data = tiny_setup
    params = _params(model, cfg)
    ck = DedupCheckpointer(DedupCluster.create(4, chunking=CH), device="cpu")
    ck.save("a", params)
    ck.save("b", params)
    ck.delete("a")
    _assert_bitwise(params, ck.restore("b", like=params))  # must survive a's deletion


def test_crash_mid_save_older_checkpoint_safe(tiny_setup):
    cfg, model, data = tiny_setup
    params = _params(model, cfg)
    cluster = DedupCluster.create(4, replicas=2, chunking=CH)
    ck = DedupCheckpointer(cluster, CheckpointConfig(device_fp_fastpath=False), device="cpu")
    ck.save("good", params)
    calls = {"n": 0}

    def inj(event, ctx):
        if event == "before_chunk_op":
            calls["n"] += 1
            if calls["n"] == 29:
                raise TransactionAbort("host died mid-checkpoint")

    cluster.fault_injector = inj
    mutated = jax.tree.map(lambda x: x + 1 if x.dtype != torch.int32 else x, params)
    try:
        ck.save("crashy", mutated)
    except WriteError:
        pass
    cluster.fault_injector = None
    _assert_bitwise(params, ck.restore("good", like=params))
    # garbage from the failed save is collectable
    cluster.tick(20); cluster.run_gc(); cluster.tick(20)
    cluster.run_gc()
    _assert_bitwise(params, ck.restore("good", like=params))  # still intact post-GC


def test_restore_with_node_down_uses_replicas(tiny_setup):
    cfg, model, data = tiny_setup
    params = _params(model, cfg)
    cluster = DedupCluster.create(5, replicas=2, chunking=CH)
    ck = DedupCheckpointer(cluster, device="cpu")
    ck.save("s", params)
    cluster.crash_node(list(cluster.nodes)[1])
    _assert_bitwise(params, ck.restore("s", like=params))


# ------------------------------------------------------ across packages ---
def _jax_steps(jm, js, data, steps, opt):
    step = jax.jit(jbuild_train_step(jm, JAdamWConfig(**opt), 1))
    met = None
    for i in steps:
        js, met = step(js, _jax(data.batch(i)))
    return js, met


def test_jax_train_checkpoint_resumes_in_the_port():
    """The JAX package trains 2 steps and saves its state; the port
    restores it with ``like=`` and takes step 3 to the JAX package's loss
    and state."""
    jm, js, tm, _ = _states("qwen")
    data = SyntheticLMData(vocab=tm.cfg.vocab, seq_len=16, global_batch=2, seed=3)
    js, _ = _jax_steps(jm, js, data, range(2), OPT)
    jc = jcore.DedupCluster.create(4, replicas=2, chunking=jcore.ChunkingSpec("fixed", 64 * 1024))
    JCheckpointer(jc).save("step-2", js)
    js3, jmet = _jax_steps(jm, js, data, [2], OPT)

    like = train_state_to_tree(init_train_state(tm, 9, AdamWConfig(**OPT)), tm.cfg)
    tree = DedupCheckpointer(jc, device="cpu").restore("step-2", like=like)
    _assert_bitwise(tree, numpy_tree(jax.device_get(js)))
    ts = train_state_from_tree(tree, tm.cfg, device="cpu")
    assert int(ts["opt"]["step"]) == 2
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, _torch(data.batch(2)))
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_trees_close(train_state_to_tree(ts3, tm.cfg), jax.device_get(js3), "float32")


def test_port_train_checkpoint_resumes_in_jax():
    """The port trains 2 steps (``train_loop``'s hook saves step-2); the
    JAX package restores it with ``like=`` and takes step 3 to the port's
    loss and state."""
    jm, js0, tm, ts = _states("qwen")
    data = SyntheticLMData(vocab=tm.cfg.vocab, seq_len=16, global_batch=2, seed=4)
    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 64 * 1024))
    ck = DedupCheckpointer(tc, device="cpu")
    ts, _ = train_loop(tm, data, TrainConfig(steps=2, checkpoint_every=2, opt=AdamWConfig(**OPT)),
                       checkpointer=ck, state=ts)
    assert ck.list_checkpoints() == ["step-2"]
    jstate = JCheckpointer(tc).restore("step-2", like=js0)
    _assert_bitwise(train_state_to_tree(ts, tm.cfg), numpy_tree(jstate))
    js3, jmet = _jax_steps(jm, jstate, data, [2], OPT)
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, _torch(data.batch(2)))
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_trees_close(train_state_to_tree(ts3, tm.cfg), jax.device_get(js3), "float32")


def test_train_state_tree_round_trip_and_leaf_keys():
    """train_state_from_tree inverts train_state_to_tree (with err), and the
    tree's leaf keys are the JAX train state's."""
    opt = dict(OPT, compress_grads=True)
    jm, js, tm, ts = _states("llava", "bfloat16", opt=opt)
    tree = train_state_to_tree(ts, tm.cfg)
    _assert_bitwise(tree, numpy_tree(js))
    back = train_state_to_tree(train_state_from_tree(tree, tm.cfg, device="cpu"), tm.cfg)
    _assert_bitwise(tree, back)
    assert len(_leaf_paths(tree)) == 5 * 12 + 1


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
    assert line["restored_loss_step2"] == line["live_loss_step2"]
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


# --------------------------------------------------------------- launcher ---
def _mask_floats(text: str) -> list[str]:
    return [re.sub(r"\d+\.\d+", "#", line) for line in text.splitlines()]


def test_train_launcher_prints_the_jax_lines(capsys, monkeypatch):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--arch", "qwen2.5-32b", "--steps", "4", "--ckpt-every", "2", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    # The weights differ (each package draws its own), so the losses and
    # seconds do; the lines, the checkpoints and the save stats do not.
    assert _mask_floats(got) == _mask_floats(want)
    assert got.splitlines()[-3] == want.splitlines()[-3] == "checkpoints: ['step-2', 'step-4']"
    assert got.splitlines()[-1] == want.splitlines()[-1]  # ckpt stats
    with pytest.raises(SystemExit, match="A5"):
        ttrain.main([*flags, "--dryrun"])
    # --shape only sizes the reference's dry run, so the port refuses it
    with pytest.raises(SystemExit):
        ttrain.main([*flags, "--shape", "train_4k"])


def test_train_launcher_resumes(capsys, monkeypatch):
    """--resume restores a checkpoint of the launcher's cluster and goes on
    from its step (one cluster shared by two runs in one process)."""
    from repro_torch.launch import train as ttrain

    shared = {}
    create = tcore.DedupCluster.create.__func__

    def create_once(cls, *a, **kw):
        if "c" not in shared:
            shared["c"] = create(cls, *a, **kw)
        return shared["c"]

    monkeypatch.setattr(tcore.DedupCluster, "create", classmethod(create_once))
    flags = ["--arch", "qwen2.5-32b", "--ckpt-every", "2", "--seq", "16", "--batch", "2", "--device", "cpu"]
    ttrain.main([*flags, "--steps", "2"])
    capsys.readouterr()
    ttrain.main([*flags, "--steps", "4", "--resume", "step-2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "resumed from step-2 at step 2"
    assert re.fullmatch(r"step     3 loss \d+\.\d{4} \(\d+\.\d{2}s\)", lines[1]), lines
    assert lines[2] == "checkpoints: ['step-2', 'step-4']"
