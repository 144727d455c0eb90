"""The port's multi-head latent attention (reduced MiniCPM3-4B: qk head dim
16 + 8 rope, v head dim 16, kv rank 16, 2 layers) held against the JAX
package's, on the CPU.

The JAX side builds the parameters and the same values reach the port
through ``params_from_numpy`` (or its train-state twin); inputs come from
seeded numpy. Outputs agree within the reference's tolerances: 2e-4 with
float32 parameters, 3e-2 with bfloat16 ones
(``tests/test_flash_attn_kernel.py:46,58``). The Pallas kernel never sees
a v head dim that differs from the qk one, so the plain attention with
``dv != dqk`` is held against the JAX package's ``chunked_attention``, as
``tests/test_chunked_attn.py`` holds it. The JAX models and their jitted
functions are built once per module.
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
from repro.models import mla as jmla
from repro.models import transformer as jT
from repro.models.layers import chunked_attention as jchunked_attention
from repro.models.layers import quantize_dense_weights as jquant
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.loop import build_train_step as jbuild_train_step
from repro.train.loop import init_train_state as jinit_train_state
from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import flash_attention_plain
from repro_torch.models import build_model
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as tT
from repro_torch.models.convert import (
    _tree_of_named,
    params_from_numpy,
    params_to_numpy,
    train_state_from_tree,
    train_state_to_tree,
)
from repro_torch.models.layers import quantize_dense_weights as tquant
from repro_torch.models.transformer import zeros_from_specs
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop
from repro_torch.train.loop import build_train_step, init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 10's traffic and the flash bound)

ARCH = "minicpm3-4b"
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


def _rel_max(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _cfgs(dtype: str = "float32", **overrides):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=_TORCH[dtype], **overrides)
    return jcfg, tcfg


@functools.cache
def _jax_pair(dtype: str, seed: int = 0, **overrides):
    """The JAX model and its parameters (built once per module)."""
    jcfg, _ = _cfgs(dtype, **overrides)
    jm = jbuild_model(jcfg)
    return jm, jm.init(jax.random.PRNGKey(seed))


def pair(dtype: str = "float32", seed: int = 0, **overrides):
    """(JAX model, JAX params, port model, port params) with equal weights;
    the port's parameters are fresh each call."""
    jm, jp = _jax_pair(dtype, seed, **overrides)
    tcfg = _cfgs(dtype, **overrides)[1]
    return jm, jp, build_model(tcfg, device="cpu"), params_from_numpy(numpy_tree(jp), tcfg, device="cpu")


def _tokens(seed: int, shape, vocab: int):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _flat(tree):
    """Leaves of a (JAX or port) cache tree in the JAX flattening order."""
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _layer0(dtype: str, impl: str = "dense"):
    """Layer 0's MLA parameters in both packages and the two specs."""
    jm, jp, tm, tp = pair(dtype, attn_impl=impl, attn_q_chunk=8, attn_kv_chunk=8)
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    return jT._mla_spec(jm.cfg), jparams, tT._mla_spec(tm.cfg), tp.blocks[0].attn


def _x(seed: int, shape, dtype: str):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(_JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def _positions(b: int, s: int):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


# ------------------------------------------------------------ functions ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latents_and_queries_match_jax(dtype):
    jspec, jp, tspec, tp = _layer0(dtype)
    jx, tx = _x(1, (2, 12, tspec.d_model), dtype)
    jpos, tpos = _positions(2, 12)
    (jc, jkr), (jqn, jqr) = jax.jit(
        lambda p, x, pos: (jmla._latents(p, jspec, x, pos), jmla._queries(p, jspec, x, pos)))(jp, jx, jpos)
    tc, tkr = tmla._latents(tp, tspec, tx, tpos)
    tqn, tqr = tmla._queries(tp, tspec, tx, tpos)
    for t, j in ((tc, jc), (tkr, jkr), (tqn, jqn), (tqr, jqr)):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == _TORCH[dtype]
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_mla_prefill_matches_jax(impl, dtype):
    """The expanded prefill (chunks of 8 over 16 positions on the chunked
    route) and its latent caches."""
    jspec, jp, tspec, tp = _layer0(dtype, impl)
    jx, tx = _x(2, (2, 16, tspec.d_model), dtype)
    jpos, tpos = _positions(2, 16)
    mask = jT.L._attn_mask(16, 16, 0, 0, True)
    jy, (jc, jkr) = jax.jit(lambda p, x, pos: jmla.mla_prefill(p, jspec, x, pos, mask, True))(jp, jx, jpos)
    tmask = tT.L._attn_mask(16, 16, 0, 0, True) if impl == "dense" else None
    ty, (tc, tkr) = tmla.mla_prefill(tp, tspec, tx, tpos, tmask, True)
    assert tuple(ty.shape) == tuple(jy.shape) and ty.dtype == _TORCH[dtype]
    for t, j in ((ty, jy), (tc, jc), (tkr, jkr)):
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """The absorbed decode at position 9 of 12-slot latent caches (slots past
    9 hold values the mask must hide): the output and both caches, the new
    token's slot written in place."""
    jspec, jp, tspec, tp = _layer0(dtype)
    jx, tx = _x(3, (2, 1, tspec.d_model), dtype)
    jckv, tckv = _x(4, (2, 12, tspec.kv_lora_rank), dtype)
    jkr, tkr = _x(5, (2, 12, tspec.qk_rope_head_dim), dtype)
    jy, jckv2, jkr2 = jax.jit(lambda p, x, c, k: jmla.mla_decode(p, jspec, x, c, k, 9))(jp, jx, jckv, jkr)
    ty, tckv2, tkr2 = tmla.mla_decode(tp, tspec, tx, tckv, tkr, 9)
    assert tckv2 is tckv and tkr2 is tkr
    for t, j in ((ty, jy), (tckv2, jckv2), (tkr2, jkr2)):
        _close(t, j, dtype)


# ----------------------------------------------------------- full models ---
@pytest.mark.parametrize("dtype,attn_impl", [("float32", "dense"), ("float32", "chunked"), ("bfloat16", "chunked")])
def test_prefill_and_decode_match_jax(dtype, attn_impl):
    """A 24-token prefill into 28-slot caches and 2 decode steps: the
    logits, and every cache leaf."""
    jm, jp, tm, tp = pair(dtype, attn_impl=attn_impl, attn_q_chunk=8, attn_kv_chunk=8)
    toks = _tokens(0, (2, 24), tm.cfg.vocab)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, {"tokens": jnp.asarray(toks)}, 28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=28)
    assert tl.shape == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    _close(tl, jl, dtype)
    assert [tuple(t.shape) for t in _flat(tc)] == [tuple(j.shape) for j in _flat(jc)]
    jdecode = jax.jit(jm.decode_step)
    for pos in (24, 25):
        nxt = _tokens(pos, (2, 1), tm.cfg.vocab)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        _close(tl, jl, dtype)
    for t, j in zip(_flat(tc), _flat(jc)):
        _close(t, j, dtype)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_prefill_decode_consistency(attn_impl):
    """tests/test_models.py's check on the port: 8 decode steps after a
    16-token prefill give the last logits of a fresh 24-token prefill."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl=attn_impl)
    m = build_model(cfg, device="cpu")
    params = m.init(1)
    toks = torch.from_numpy(_tokens(0, (2, 24), cfg.vocab))
    _, caches = m.prefill(params, {"tokens": toks[:, :16]}, cache_len=24)
    lg = None
    for t in range(16, 24):
        lg, caches = m.decode_step(params, caches, toks[:, t : t + 1], t)
    ref, _ = m.prefill(params, {"tokens": toks}, cache_len=24)
    assert _rel_max(lg[:, 0], ref[:, 0]) < 0.05


def test_model_level_dense_vs_chunked():
    """tests/test_chunked_attn.py's check on the port: the loss through
    dense and chunked attention (chunks of 16 / 8) within 2e-3, and each
    as the JAX package's."""
    jm, jp, tm_d, tp = pair("float32")
    tm_c = build_model(dataclasses.replace(tm_d.cfg, attn_impl="chunked", attn_q_chunk=16, attn_kv_chunk=8),
                       device="cpu")
    toks = _tokens(7, (2, 33), tm_d.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    with torch.no_grad():
        ld, _ = tm_d.loss_fn(tp, tb)
        lc, _ = tm_c.loss_fn(tp, tb)
    assert abs(float(ld) - float(lc)) < 2e-3
    jl, _ = jax.jit(jm.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(ld, jl, "float32")
    _close(lc, jl, "float32")


@pytest.mark.parametrize("kv_cache_quant", [False, True])
def test_cache_specs_match_jax(kv_cache_quant):
    """The (B, S, r) and (B, S, rope) latent caches, in the model dtype also
    under kv_cache_quant, as the reference's."""
    jcfg, tcfg = _cfgs("bfloat16", kv_cache_quant=kv_cache_quant)
    specs = build_model(tcfg, device="cpu").cache_specs(ShapeSpec("d", 48, 2, "decode"))
    jspecs = jbuild_model(jcfg).cache_specs(JShapeSpec("d", 48, 2, "decode"))
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tT.TensorSpec))
    assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in tleaves] == \
        [(j.shape, j.dtype.name) for j in jleaves] == [((2, 2, 48, 16), "bfloat16"), ((2, 2, 48, 8), "bfloat16")]


# ------------------------------------------------------- quantized serving ---
def _greedy(model, params, toks, *, torch_side: bool, n: int):
    """Feed ``n`` tokens through decode_step from empty caches; the last logits."""
    if torch_side:
        caches = zeros_from_specs(model.cache_specs(ShapeSpec("d", 32, 2, "decode")), "cpu")
    else:
        cs = model.cache_specs(JShapeSpec("d", 32, 2, "decode"))
        caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cs,
                              is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
        decode = jax.jit(model.decode_step)
    lg = None
    for t in range(n):
        if torch_side:
            lg, caches = model.decode_step(params, caches, torch.from_numpy(toks[:, t : t + 1]), t)
        else:
            lg, caches = decode(params, caches, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
    return _np(lg[:, 0])


def test_w8_weights_close_to_bf16_and_to_jax():
    """tests/test_quantized_serving.py's w8a16 check on the port (24 greedy
    decode steps, w8a16 against bfloat16 weights: relative max error < 0.2,
    the argmax agreeing on >= half the rows), with the JAX package's
    quantized weights carried across as they are; and the port's w8a16
    decode against the JAX package's on those weights, within 3e-2. The
    absorbed decode dequantizes w_uk and w_uv (``raw_weight``)."""
    jm_b, jp_b, tm_b, tp_b = pair("bfloat16")
    jm_q, jp_q, tm_q, tp_q = pair("bfloat16", weight_quant=True)
    attn = tp_q.blocks[0].attn
    assert all(getattr(attn, n).w.dtype == torch.int8 for n in tmla.LEAVES if n not in tmla.NORMS)
    toks = _tokens(0, (2, 24), tm_b.cfg.vocab)
    a = _greedy(tm_b, tp_b, toks, torch_side=True, n=24)
    b = _greedy(tm_q, tp_q, toks, torch_side=True, n=24)
    assert _rel_max(a, b) < 0.2
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5
    _close(b, _greedy(jm_q, jp_q, toks, torch_side=False, n=24), "bfloat16")


def test_port_quantizer_reaches_mla_leaves_as_jax():
    """``quantize_dense_weights`` turns MLA's seven Dense leaves into int8 +
    a per-layer scale, the JAX package's values on the same bfloat16
    weights; its norms keep their dtype."""
    _, jp, tm, tp = pair("bfloat16")
    jq = numpy_tree(jquant(jp))["blocks"][0]["attn"]
    tq = params_to_numpy(tquant(tp), tm.cfg)["blocks"][0]["attn"]
    for n in tmla.LEAVES:
        if n in tmla.NORMS:
            assert "w" not in tq[n] and tq[n]["scale"].dtype == np.uint16
            continue
        assert tq[n]["w"].dtype == np.int8
        np.testing.assert_array_equal(tq[n]["w"], jq[n]["w"])
        np.testing.assert_array_equal(tq[n]["w_scale"], jq[n]["w_scale"])


# ------------------------------------------------------ training ---
def _batch(cfg, seed: int, batch: int = 2, seq: int = 24) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    out["labels"][:, :3] = -1
    return out


def test_loss_fn_and_grads_match_jax():
    """The loss and every parameter's gradient (MLA's nine leaves a layer),
    through ``attn_impl="dense"`` under ``remat="dots"``."""
    jm, jp, tm, tp = pair("float32", remat="dots")
    batch = _batch(tm.cfg, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(tp.named_parameters())
    grads = _tree_of_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))), tm.cfg)
    _close(loss, jloss, "float32")
    t_leaves = _leaf_paths(grads)
    j_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    assert sum("attn" in k for k, _ in t_leaves) == 9
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), key
        _close(t, j, "float32")


@functools.cache
def _jax_train():
    """The reduced MiniCPM3's JAX model and its jitted train step."""
    jm = _jax_pair("float32")[0]
    return jm, jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT)))


def _assert_state_close(ts, js, cfg):
    t_leaves = _leaf_paths(train_state_to_tree(ts, cfg))
    j_leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(js))[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        _close(t, j, "float32")


def test_train_step_matches_jax():
    """One AdamW train step from the same state: the metrics and the whole
    new state (parameters, master, moments)."""
    (jm, step), tcfg = _jax_train(), _cfgs()[1]
    js = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    ts = train_state_from_tree(numpy_tree(js), tcfg, device="cpu")
    batch = _batch(tcfg, 5)
    js2, jmet = step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts2, tmet = build_train_step(build_model(tcfg, device="cpu"), AdamWConfig(**OPT))(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        _close(tmet[k], jmet[k], "float32")
    _assert_state_close(ts2, js2, tcfg)


def _jax_steps(step, js, data, steps):
    met = None
    for i in steps:
        js, met = step(js, {k: jnp.asarray(v) for k, v in data.batch(i).items()})
    return js, met


def test_jax_mla_checkpoint_resumes_in_the_port():
    tcfg = _cfgs()[1]
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


def test_port_mla_checkpoint_resumes_in_jax():
    tcfg = _cfgs()[1]
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


# ------------------------------------------------------ parameter trees ---
@pytest.mark.parametrize("weight_quant", [False, True])
def test_params_round_trip(weight_quant):
    jcfg, tcfg = _cfgs("bfloat16", weight_quant=weight_quant)
    tree = numpy_tree(_jax_pair("bfloat16", 5, weight_quant=weight_quant)[1])
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_layout_matches_jax_tree():
    """The port's own init builds the tree the JAX package builds: same
    keys, shapes and dtypes, MLA's nine leaves stacked on the group axis."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = params_to_numpy(build_model(tcfg, device="cpu").init(0), tcfg)
    jspec = jbuild_model(jcfg).param_specs()
    flat_t, def_t = jax.tree.flatten(tree)
    flat_j, def_j = jax.tree.flatten(jspec)
    assert def_t == def_j
    for t, j in zip(flat_t, flat_j):
        assert t.shape == j.shape
        assert t.dtype == (np.uint16 if j.dtype == jnp.bfloat16 else j.dtype)
    assert sorted(tree["blocks"][0]["attn"]) == sorted(tmla.LEAVES)


def test_train_state_tree_round_trip_and_leaf_keys():
    jcfg, tcfg = _cfgs("bfloat16")
    js = jinit_train_state(_jax_pair("bfloat16")[0], jax.random.PRNGKey(0), JAdamWConfig(**OPT, compress_grads=True))
    back = train_state_to_tree(train_state_from_tree(numpy_tree(js), tcfg, device="cpu"), tcfg)
    t_leaves = _leaf_paths(back)
    j_leaves = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        t = t.detach().reshape(-1)
        t = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().view(np.uint8)
        assert np.array_equal(t, np.asarray(j).reshape(-1).view(np.uint8)), key


# ------------------------------------------------------------- launcher ---
def test_train_launcher_prints_the_jax_lines(capsys, monkeypatch):
    """The launcher's step lines equal the reference's up to the losses and
    seconds."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--arch", ARCH, "--steps", "4", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    mask = lambda text: [re.sub(r"\d+\.\d+", "#", line) for line in text.splitlines()]
    assert mask(got) == mask(want) == ["step     0 loss # (#s)", "step     3 loss # (#s)"]


# ------------------------------------------- plain attention with dv != dqk ---
@pytest.mark.parametrize("dqk,dv,s", [(24, 16, 40), (96, 64, 100)])
def test_flash_plain_with_v_head_dim_unlike_qk_matches_jax(dqk, dv, s):
    """``ops.flash_attention`` on CPU tensors (``flash_attention_plain``) at
    the reduced and the full MLA head dims: (B, S, H, dv) out, as the JAX
    package's ``chunked_attention`` on the same inputs (scale
    1/sqrt(dqk))."""
    rng = np.random.default_rng(dqk)
    q, k = (rng.standard_normal((2, s, 4, dqk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, s, 4, dv)).astype(np.float32)
    before = tops.launch_counts["flash"]
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    assert tops.launch_counts["flash"] == before + 1 and tuple(got.shape) == (2, s, 4, dv)
    attend = jax.jit(functools.partial(jchunked_attention, causal=True, window=0, mask_offset=0, q_chunk=s // 4,
                                       kv_chunk=s // 4, scale=1.0 / np.sqrt(dqk)))
    exp = attend(jnp.asarray(q)[:, :, :, None, :], jnp.asarray(k), jnp.asarray(v))
    _close(got, np.asarray(exp).reshape(2, s, 4, dv), "float32")


def test_flash_bound_counts_both_head_dims():
    """chip_smoke.flash_bound_ms at phase 10's layer shape: 2 (96 + 64) FLOP
    a visible pair and head (4.30e11, 0.434 ms at 989 TFLOP/s), and q, k, v
    and the (1, 8192, 40, 64) output once (0.21 GB); at equal head dims it
    is 4 hd FLOP a pair and 2 (q + k) bytes, as before."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")
    q, k, v = meta(1, 8192, 40, 96), meta(1, 8192, 40, 96), meta(1, 8192, 40, 64)
    ops_ms, bytes_ms = chip_smoke.flash_bound_ms(q, k, v, True, 0)
    pairs = chip_smoke.attention_pairs(8192, 8192, True, 0)
    assert ops_ms == pytest.approx(2 * 160 * 40 * pairs / 989e12 * 1e3) and round(ops_ms, 3) == 0.434
    assert bytes_ms == pytest.approx((2 * 8192 * 40 * 96 + 2 * 8192 * 40 * 64) * 2 / 3.35e12 * 1e3)
    q, k = meta(1, 8192, 40, 128), meta(1, 8192, 8, 128)
    ops_ms, bytes_ms = chip_smoke.flash_bound_ms(q, k, k, True, 0)
    assert ops_ms == pytest.approx(4 * 128 * 40 * pairs / 989e12 * 1e3)
    assert bytes_ms == pytest.approx((2 * q.numel() + 2 * k.numel()) * 2 / 3.35e12 * 1e3)


# ----------------------------------------------- chip_smoke.py phase 10 ---
def test_chip_smoke_mla_traffic_on_cpu():
    """chip_smoke.py's phase-10 traffic at a tiny size on the CPU: prefill
    into latent caches, teacher-forced absorbed decode, the fresh prefill
    it is held against, the counts (no kernel on the CPU); and layer 0's
    flash inputs as ``mla_prefill`` makes them, whose plain attention is
    the layer's attention output."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl="chunked")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(_tokens(6, (1, 40), cfg.vocab)).long()
    out = chip_smoke.family_traffic(model, params, tokens, 32, 40)
    assert out["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}
    assert out["decode_vs_prefill_rel_err"] < 0.05
    assert {n: tuple(t.shape) for n, t in out["caches"][0][0].items()} == {"ckv": (2, 1, 40, 16), "kr": (2, 1, 40, 8)}
    q, k, v = chip_smoke.mla_layer0_qkv(params, cfg, tokens[:, :32])
    assert (tuple(q.shape), tuple(k.shape), tuple(v.shape)) == ((1, 32, 4, 24), (1, 32, 4, 24), (1, 32, 4, 16))
    blk = params.blocks[0]
    spec = tT._mla_spec(cfg)
    with torch.no_grad():
        h = tT.L.rms_norm(blk.norm1, tT.L.embed(params.embed, tokens[:, :32]), cfg.norm_eps)
        want = tmla.mla_prefill(blk.attn, spec, h, torch.arange(32)[None])
        got = tT.L.dense(blk.attn.wo, flash_attention_plain(q, k, v).reshape(1, 32, -1))
    _close(got, want, "float32")


@pytest.mark.parametrize("cache", ["ckv", "kr"])
def test_chip_smoke_float32_check_fails_a_planted_decode_fault(monkeypatch, cache):
    """Phase 10's float32 check has teeth: with the decode leaving the new
    token's ``ckv`` or ``kr`` slot unwritten (a fault planted at run time),
    the last decode logits of the reduced model in float32 sit beyond
    2e-4 of the fresh prefill; the sound decode sits within it."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl="chunked", param_dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(_tokens(8, (1, 40), cfg.vocab)).long()
    limit = chip_smoke.DECODE_REL_LIMIT["float32"]
    assert chip_smoke.family_traffic(model, params, tokens, 32, 40)["decode_vs_prefill_rel_err"] < limit
    sound = tmla.mla_decode

    def unwritten(p, s, x, ckv, kr, pos):
        slot = {"ckv": ckv, "kr": kr}[cache]
        kept = slot[:, pos].clone()
        out = sound(p, s, x, ckv, kr, pos)
        slot[:, pos] = kept
        return out

    monkeypatch.setattr(tmla, "mla_decode", unwritten)
    assert chip_smoke.family_traffic(model, params, tokens, 32, 40)["decode_vs_prefill_rel_err"] > limit
