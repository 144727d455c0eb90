"""The port's sliding-window and RG-LRU families (reduced Gemma3-12B and
RecurrentGemma-2B) held against the JAX package's, on the CPU.

The JAX side builds the parameters (``init_decoder`` or ``init_rglru`` from
a PRNG key) and the same values reach the port through
``params_from_numpy`` (or its train-state twin); inputs come from seeded
numpy. Outputs must agree within the reference's tolerances: 2e-4 with
float32 parameters, 3e-2 with bfloat16 ones
(``tests/test_flash_attn_kernel.py:46,58``); index tensors (the ring
cache's ``pos_idx``) and bit-carried tensors exactly.
"""

import dataclasses
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
from repro.kernels.flash_attn import flash_attention_pallas
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.loop import build_train_step as jbuild_train_step
from repro.train.loop import init_train_state as jinit_train_state
from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
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
import chip_smoke  # noqa: E402  (phase 8's traffic)

ARCHS = ("gemma3-12b", "recurrentgemma-2b")
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


# ------------------------------------------------------------ ring cache ---
@pytest.mark.parametrize("sl", [20, 32, 45])
def test_ring_cache_from_prefill_matches_jax(sl):
    """S < w (padded, pos_idx -1), S == w and S > w (slot t % w)."""
    jcfg, tcfg = _cfgs("gemma3-12b")
    rng = np.random.default_rng(sl)
    k, v = (rng.standard_normal((2, sl, 2, 32)).astype(np.float32) for _ in range(2))
    j = jT._ring_cache_from_prefill(jcfg, "attn_local", jnp.asarray(k), jnp.asarray(v))
    t = tT._ring_cache_from_prefill(tcfg, torch.from_numpy(k), torch.from_numpy(v))
    assert sorted(t) == sorted(j) == ["k", "pos_idx", "v"]
    for name in j:
        assert t[name].dtype == {"pos_idx": torch.int32}.get(name, torch.float32)
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]))


@pytest.mark.parametrize("int8_cache", [False, True])
def test_local_decode_matches_jax(int8_cache):
    """One ring decode step on a cache with empty (-1), stale and live slots:
    the output, and the k/v/pos_idx written into slot pos % w (in place in
    the port). An int8 cache quantizes the new k/v, as under kv_cache_quant."""
    jm, jp, tm, tp = pair("gemma3-12b")
    cfg, w = tm.cfg, tm.cfg.window
    rng = np.random.default_rng(5)
    shape = (2, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    if int8_cache:
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = 70
    pos_idx = np.arange(pos - w, pos, dtype=np.int32)
    pos_idx[3], pos_idx[7], pos_idx[11] = -1, pos - w - 5, pos + 4  # empty, before the window, ahead
    h = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    jy, jc = jT._local_decode(jattn, jm.cfg, jnp.asarray(h),
                              {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos_idx": jnp.asarray(pos_idx)}, pos)
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()), "pos_idx": torch.from_numpy(pos_idx.copy())}
    ty, out = tT._local_decode(tp.blocks[0].attn, cfg, torch.from_numpy(h), tc, pos)
    _close(ty, jy, "float32")
    assert all(out[n] is tc[n] for n in tc)  # written in place
    np.testing.assert_array_equal(out["pos_idx"].numpy(), np.asarray(jc["pos_idx"]))
    for n in ("k", "v"):
        assert out[n].dtype == (torch.int8 if int8_cache else torch.float32)
        if int8_cache:
            np.testing.assert_array_equal(out[n].numpy(), np.asarray(jc[n]))
        else:
            _close(out[n], jc[n], "float32")


def test_local_attention_ring_cache_exactness():
    """tests/test_models.py's check on the port: a ring-buffer local cache
    decoded 16 tokens past a 16-token prefill (window 8: 4 windows deep)
    gives the last logits of a full 32-token prefill."""
    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(), window=8,
                              block_pattern=("attn_local",), n_layers=2)
    m = build_model(cfg, device="cpu")
    params = m.init(2)
    toks = torch.from_numpy(_tokens(1, (1, 32), cfg.vocab))
    _, caches = m.prefill(params, {"tokens": toks[:, :16]}, cache_len=32)
    lg = None
    for t in range(16, 32):
        lg, caches = m.decode_step(params, caches, toks[:, t : t + 1], t)
    ref, _ = m.prefill(params, {"tokens": toks}, cache_len=32)
    a, b = lg[:, 0].float(), ref[:, 0].float()
    assert float((a - b).abs().max() / (b.abs().max() + 1e-6)) < 0.05


# ----------------------------------------------------------- full models ---
@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, attn_impl):
    """A 40-token prefill (past the reduced window of 32, so the rings wrap)
    and 2 decode steps: the logits, and every cache leaf in float32. In
    bfloat16 the two frameworks round activations at other places, which
    compounds over the layers, so there the cache leaves compared are the
    first layer's (layer 0 of the pattern, as test_torch_models does)."""
    jm, jp, tm, tp = pair(arch, dtype, attn_impl=attn_impl, attn_q_chunk=8, attn_kv_chunk=8)
    jprefill, jdecode = jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step)
    toks = _tokens(0, (2, 40), tm.cfg.vocab)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, 48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=48)
    assert tl.shape == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    _close(tl, jl, dtype)
    assert [tuple(t.shape) for t in _flat(tc)] == [tuple(j.shape) for j in _flat(jc)]

    def check_caches():
        pairs = zip(_flat(tc), _flat(jc)) if dtype == "float32" else \
            ((tc[0][0][n][0], jc[0][0][n][0]) for n in tc[0][0])
        for t, j in pairs:
            _close(t, j, dtype)

    check_caches()
    for pos in (40, 41):
        nxt = _tokens(pos, (2, 1), tm.cfg.vocab)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        _close(tl, jl, dtype)
    check_caches()


@pytest.mark.parametrize("kv_cache_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, kv_cache_quant):
    """``cache_specs``: local rings of ``window`` slots (int8 under
    kv_cache_quant) with their int32 ``pos_idx``, the RG-LRU's float32
    state and its conv window, in the JAX tree's order."""
    jcfg, tcfg = _cfgs(arch, kv_cache_quant=kv_cache_quant)
    specs = build_model(tcfg, device="cpu").cache_specs(ShapeSpec("d", 48, 2, "decode"))
    jspecs = jbuild_model(jcfg).cache_specs(JShapeSpec("d", 48, 2, "decode"))
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tT.TensorSpec))
    assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in tleaves] == \
        [(j.shape, j.dtype.name) for j in jleaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_caches_matches_jax(arch):
    """Caches made from ``cache_specs``, then 40 decode steps: the rings
    wrap (window 32) and the last logits agree. The int8 ring's decode is
    held to JAX in ``test_local_decode_matches_jax``: over 40 steps a
    quantization step that the two frameworks' float32 rounding puts on
    either side moves logits past 2e-4."""
    jm, jp, tm, tp = pair(arch)
    tc = tT.zeros_from_specs(tm.cache_specs(ShapeSpec("d", 48, 2, "decode")), "cpu")
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jm.cache_specs(JShapeSpec("d", 48, 2, "decode")),
                      is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    jdecode = jax.jit(jm.decode_step)
    toks = _tokens(4, (2, 40), tm.cfg.vocab)
    for t in range(40):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t : t + 1]), t)
    _close(tl, jl, "float32")


# ------------------------------------------------------------------ RG-LRU --
def _rglru_pair(dtype: str, seed: int = 0):
    spec = jssm.RGLRUSpec(d_model=48, width=64, n_blocks=4)
    jp = jssm.init_rglru(jax.random.PRNGKey(seed), spec, _JNP[dtype])
    # non-zero biases so the gates' fp32 biases are exercised
    rng = np.random.default_rng(seed)
    jp = dict(jp, b_r=jnp.asarray(rng.standard_normal(64), jnp.float32),
              b_i=jnp.asarray(rng.standard_normal(64), jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(64) * 0.1, _JNP[dtype]))
    blk = params_from_numpy({"blocks": (), "tail": ({"norm1": {"scale": np.ones(48, np.float32)},
                                                     "mixer": numpy_tree(jp)},),
                             "embed": {"table": np.zeros((1, 48), np.float32)},
                             "final_norm": {"scale": np.ones(48, np.float32)}},
                            dataclasses.replace(get_config("recurrentgemma-2b").reduced(), n_layers=2),
                            device="cpu").tail[0]
    return spec, jp, tssm.RGLRUSpec(d_model=48, width=64, n_blocks=4), blk.mixer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_prefill_and_decode_match_jax(dtype):
    jspec, jp, tspec, tp = _rglru_pair(dtype)
    assert tp.b_r.dtype == tp.b_i.dtype == tp.lam.dtype == torch.float32
    assert tp.w_r.dtype == tp.conv_w.dtype == _TORCH[dtype]
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 37, 48)).astype(np.float32)
    ju, tu = jnp.asarray(u).astype(_JNP[dtype]), torch.from_numpy(u).to(_TORCH[dtype])
    jy, (jh, jconv) = jssm.rglru_prefill(jp, jspec, ju, True)
    ty, (th, tconv) = tssm.rglru_prefill(tp, tspec, tu, True)
    assert th.dtype == torch.float32 and tconv.dtype == _TORCH[dtype] and tuple(tconv.shape) == (2, 3, 64)
    for t, j in ((ty, jy), (th, jh), (tconv, jconv)):
        _close(t, j, dtype)
    assert torch.equal(tssm.rglru_prefill(tp, tspec, tu), ty)  # the cache changes nothing
    x = rng.standard_normal((2, 1, 48)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(_JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])
    jy2, jh2, jconv2 = jssm.rglru_decode(jp, jspec, jx, jh, jconv)
    h_in, conv_in = th.clone(), tconv.clone()
    ty2, th2, tconv2 = tssm.rglru_decode(tp, tspec, tx, h_in, conv_in)
    assert th2 is h_in and tconv2 is conv_in  # updated in place
    for t, j in ((ty2, jy2), (th2, jh2), (tconv2, jconv2)):
        _close(t, j, dtype)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 100])
def test_linear_scan_matches_a_sequential_loop(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 8)).astype(np.float32))
    want, h = [], torch.zeros((2, 8))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tssm._linear_scan(a, b), torch.stack(want, dim=1), rtol=1e-5, atol=1e-6)


def test_rglru_decode_continues_its_prefill():
    """Prefill 20 positions, then decode 5 from its (state, conv) cache: the
    outputs are those of a 25-position prefill."""
    _, _, spec, p = _rglru_pair("float32")
    u = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 25, 48)).astype(np.float32))
    full = tssm.rglru_prefill(p, spec, u)
    _, (h, conv) = tssm.rglru_prefill(p, spec, u[:, :20], True)
    h, conv = h.clone(), conv.clone()
    for t in range(20, 25):
        y, _, _ = tssm.rglru_decode(p, spec, u[:, t : t + 1], h, conv)
        torch.testing.assert_close(y, full[:, t : t + 1], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------- loss and grads ---
def _batch(cfg, seed: int, batch: int = 2, seq: int = 40) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    out["labels"][:, :3] = -1
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, dtype):
    jm, jp, tm, tp = pair(arch, dtype)
    batch = _batch(tm.cfg, 1)
    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(tp.named_parameters())
    grads = _tree_of_named(dict(zip(named, torch.autograd.grad(total, list(named.values())))), tm.cfg)
    _close(total, jtotal, dtype)
    assert float(met["tokens"]) == float(jmet["tokens"]) == batch["tokens"].size - 6
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
    keys, shapes and dtypes (RG-LRU's b_r, b_i, lam in float32)."""
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
    jcfg, tcfg = _cfgs("recurrentgemma-2b", "bfloat16")
    js = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0), JAdamWConfig(**OPT, compress_grads=True))
    tree = numpy_tree(js)
    ts = train_state_from_tree(tree, tcfg, device="cpu")
    back = train_state_to_tree(ts, tcfg)
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


def test_jax_recurrentgemma_checkpoint_resumes_in_the_port():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    js = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=3)
    step = jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT)))
    js, _ = _jax_steps(step, js, data, range(2))
    jc = jcore.DedupCluster.create(4, replicas=2, chunking=jcore.ChunkingSpec("fixed", 64 * 1024))
    # the host path: the JAX package's device path runs its Pallas kernels
    # interpreted here, minutes for the state's 527 leaves
    JCheckpointer(jc, JCheckpointConfig(device_fp_fastpath=False)).save("step-2", js)
    js3, jmet = _jax_steps(step, js, data, [2])
    like = train_state_to_tree(init_train_state(tm, 9, AdamWConfig(**OPT)), tcfg)
    ts = train_state_from_tree(DedupCheckpointer(jc, device="cpu").restore("step-2", like=like), tcfg, device="cpu")
    assert int(ts["opt"]["step"]) == 2
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, {k: torch.from_numpy(v) for k, v in data.batch(2).items()})
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_state_close(ts3, js3, tcfg)


def test_port_recurrentgemma_checkpoint_resumes_in_jax():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    js0 = jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    ts = train_state_from_tree(numpy_tree(js0), tcfg, device="cpu")
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=4)
    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 64 * 1024))
    ck = DedupCheckpointer(tc, device="cpu")
    ts, _ = train_loop(tm, data, TrainConfig(steps=2, checkpoint_every=2, opt=AdamWConfig(**OPT)),
                       checkpointer=ck, state=ts)
    jstate = JCheckpointer(tc).restore("step-2", like=js0)
    js3, jmet = _jax_steps(jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT))), jstate, data, [2])
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, {k: torch.from_numpy(v) for k, v in data.batch(2).items()})
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_state_close(ts3, js3, tcfg)


# ------------------------------------------------------------- launcher ---
@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_prints_the_jax_lines(arch, capsys, monkeypatch):
    """The launcher's step lines equal the reference's up to the losses and
    seconds. Without checkpoints: the JAX package's saves run its Pallas
    kernels interpreted here (minutes for these states); the launcher's
    checkpoint lines are held in test_torch_train.py, and these states'
    checkpoints by the two resume tests above."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--arch", arch, "--steps", "4", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    mask = lambda text: [re.sub(r"\d+\.\d+", "#", line) for line in text.splitlines()]
    assert mask(got) == mask(want) == ["step     0 loss # (#s)", "step     3 loss # (#s)"]


def test_chip_smoke_family_traffic_on_cpu():
    """chip_smoke.py's phase-8 traffic at a tiny size on the CPU: prefill,
    teacher-forced decode past the window (the rings wrap), the fresh
    prefill it is held against, and the counts (no kernel on the CPU)."""
    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(), window=8, attn_impl="chunked")
    model = build_model(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(6, (1, 40), cfg.vocab)).long()
    out = chip_smoke.family_traffic(model, model.init(0), tokens, 24, 40)
    assert out["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}
    assert out["decode_vs_prefill_rel_err"] < 0.05
    assert all(int(c["pos_idx"].max()) == 39 for c in out["caches"][0] if "pos_idx" in c)


# ----------------------------------------------------- flash at hd 256 ---
@pytest.mark.parametrize("window", [0, 64])
def test_flash_cpu_route_at_head_dim_256_matches_pallas_interpret(window):
    """The CPU route of ``ops.flash_attention`` at the head dim of both
    families (256), Sq 256 against Skv 512, causal."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, 256, 4, 256), (1, 512, 2, 256), (1, 512, 2, 256)))
    exp = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
                                 blk_q=64, blk_kv=64, interpret=True)
    before = tops.launch_counts["flash"]
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, window=window)
    assert tops.launch_counts["flash"] == before + 1
    _close(got, exp, "float32")
