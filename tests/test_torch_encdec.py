"""The port's encoder-decoder (reduced Whisper-tiny) held against the JAX
package's, on the CPU.

The JAX side builds the parameters and the same values reach the port
through ``params_from_numpy``; frame embeddings and tokens come from seeded
numpy. Outputs agree within the reference's tolerances: 2e-4 with float32
parameters, 3e-2 with bfloat16 ones (``tests/test_flash_attn_kernel.py:46,58``).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import build_model as jbuild_model
from repro.models import encdec as jED
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import build_model
from repro_torch.models import encdec as tED
from repro_torch.models import transformer as tT
from repro_torch.models.convert import (
    _tree_of_named,
    params_from_numpy,
    params_to_numpy,
    params_tree,
    train_state_from_tree,
    train_state_to_tree,
)
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 9's traffic)

ARCH = "whisper-tiny"
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _cfgs(dtype: str = "float32", **overrides):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=_TORCH[dtype], **overrides)
    return jcfg, tcfg


def pair(dtype: str = "float32", seed: int = 0):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jcfg, tcfg = _cfgs(dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(numpy_tree(jp), tcfg, device="cpu")


def _inputs(seed: int, cfg, s_enc: int, s_dec: int, dtype: str, batch: int = 2):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(batch, s_dec)).astype(np.int32)
    return (jnp.asarray(frames).astype(_JNP[dtype]), jnp.asarray(toks),
            torch.from_numpy(frames).to(_TORCH[dtype]), torch.from_numpy(toks))


def _flat(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_train_match_jax(dtype):
    """The bidirectional encoder over 30 frames, and the decoder's logits
    over 20 tokens attending to it."""
    jm, jp, tm, tp = pair(dtype)
    jf, jt, tf, tt = _inputs(1, tm.cfg, 30, 20, dtype)
    jenc = jax.jit(lambda p, f: jED.encode(p, jm.cfg, f))(jp, jf)
    tenc = tED.encode(tp, tm.cfg, tf)
    assert tenc.dtype == _TORCH[dtype]
    _close(tenc, jenc, dtype)
    jl = jax.jit(lambda p, t, e: jED.decode_train(p, jm.cfg, t, e))(jp, jt, jenc)
    with torch.no_grad():
        tl = tED.decode_train(tp, tm.cfg, tt, tenc)
    assert tuple(tl.shape) == (2, 20, tm.cfg.padded_vocab)
    _close(tl, jl, dtype)


def _check_caches(tc, jc, dtype):
    for t, j in zip(_flat(tc), _flat(jc)):
        _close(t if dtype == "float32" else t[0], j if dtype == "float32" else j[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A 20-token prefill over 30 frames: the logits and every cache leaf
    (self and cross K/V, layer axis first); then, on self caches the caller
    padded to 24 slots, 3 decode steps (cross attention in the model dtype,
    as the reference). In bfloat16 the two frameworks round activations at
    other places, which compounds over the layers, so there the cache
    leaves compared are layer 0's (as test_torch_families does)."""
    jm, jp, tm, tp = pair(dtype)
    jf, jt, tf, tt = _inputs(2, tm.cfg, 30, 20, dtype)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jt, "frame_embeds": jf})
    tl, tc = tm.prefill(tp, {"tokens": tt, "frame_embeds": tf})
    assert tuple(tl.shape) == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    _close(tl, jl, dtype)
    assert [tuple(t.shape) for t in _flat(tc)] == [tuple(j.shape) for j in _flat(jc)]
    _check_caches(tc, jc, dtype)
    jc = {"self": jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))), jc["self"]),
          "cross": jc["cross"]}
    tc = chip_smoke.pad_self_caches(tc, 24)
    jdecode = jax.jit(jm.decode_step)
    for pos in (20, 21, 22):
        nxt = np.random.default_rng(pos).integers(0, tm.cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        _close(tl, jl, dtype)
    _check_caches(tc, jc, dtype)


def test_decode_past_the_self_caches_raises():
    """The prefill's self caches hold exactly its tokens; the reference
    clamps a later write silently, the port raises."""
    _, _, tm, tp = pair()
    _, _, tf, tt = _inputs(3, tm.cfg, 12, 8, "float32")
    _, caches = tm.prefill(tp, {"tokens": tt, "frame_embeds": tf})
    before = caches["self"]["k"].clone()
    with pytest.raises(IndexError, match="outside the self caches' 8 slots"):
        tm.decode_step(tp, caches, tt[:, :1], 8)
    assert torch.equal(caches["self"]["k"], before)


def test_decode_continues_its_prefill():
    """8 decode steps on padded self caches give the last logits of a fresh
    prefill of all the tokens (tests/test_models.py's check, for enc-dec),
    within the float32 tolerance."""
    _, cfg = _cfgs()
    m = build_model(cfg, device="cpu")
    params = m.init(1)
    _, _, frames, toks = _inputs(4, cfg, 24, 24, "float32")
    out = chip_smoke.family_traffic(m, params, toks, 16, 0, frames=frames)
    assert out["decode_vs_prefill_rel_err"] < 2e-4
    assert out["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}


def test_cache_and_input_specs_match_jax():
    jcfg, tcfg = _cfgs()
    tm, jm = build_model(tcfg, device="cpu"), jbuild_model(jcfg)
    for kind in ("train", "prefill", "decode"):
        t_in = tm.input_specs(ShapeSpec("s", 48, 2, kind))
        j_in = jm.input_specs(JShapeSpec("s", 48, 2, kind))
        assert list(t_in) == list(j_in)
        assert [(s.shape, str(s.dtype).removeprefix("torch.")) for s in t_in.values()] == \
            [(s.shape, s.dtype.name) for s in j_in.values()]
    tleaves = jax.tree.leaves(tm.cache_specs(ShapeSpec("d", 48, 2, "decode")),
                              is_leaf=lambda x: isinstance(x, tT.TensorSpec))
    jleaves = jax.tree.leaves(jm.cache_specs(JShapeSpec("d", 48, 2, "decode")),
                              is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in tleaves] == \
        [(j.shape, j.dtype.name) for j in jleaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_jax(dtype):
    jm, jp, tm, tp = pair(dtype)
    jf, jt, tf, tt = _inputs(5, tm.cfg, 30, 21, dtype)
    labels = np.asarray(jt)[:, 1:].copy()
    labels[:, :2] = -1
    jbatch = {"frame_embeds": jf, "tokens": jt[:, :-1], "labels": jnp.asarray(labels)}
    tbatch = {"frame_embeds": tf, "tokens": tt[:, :-1], "labels": torch.from_numpy(labels)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, jbatch)
    loss, met = tm.loss_fn(tp, tbatch)
    _close(loss, jloss, dtype)
    assert float(met["aux_loss"]) == 0.0 and float(met["tokens"]) == float(jmet["tokens"]) == 36
    named = dict(tp.named_parameters())
    grads = _tree_of_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))), tm.cfg)
    t_leaves = _leaf_paths(grads)
    j_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), key
        _close(t, j, dtype)


def test_params_round_trip_and_init_layout():
    """The JAX tree through ``params_from_numpy`` and back, bit for bit; the
    port's own init builds the JAX tree's keys, shapes and dtypes; and
    ``params_tree`` stacks the same leaves."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = numpy_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(5)))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    for back in (params_to_numpy(tp, tcfg), jax.tree.map(lambda t: t.view(torch.int16).numpy().view(np.uint16),
                                                         params_tree(tp, tcfg))):
        flat_a, def_a = jax.tree.flatten(tree)
        flat_b, def_b = jax.tree.flatten(back)
        assert def_a == def_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    own = params_to_numpy(build_model(tcfg, device="cpu").init(0), tcfg)
    flat_t, def_t = jax.tree.flatten(own)
    flat_j, def_j = jax.tree.flatten(jbuild_model(jcfg).param_specs())
    assert def_t == def_j
    assert [(t.shape, t.dtype) for t in flat_t] == [(j.shape, np.dtype(np.uint16)) for j in flat_j]


def test_train_state_tree_round_trip():
    """A port train state of the enc-dec model spelled as the JAX tree
    (``enc_blocks`` / ``dec_blocks`` stacked) and read back, bit for bit."""
    _, tcfg = _cfgs("bfloat16")
    tm = build_model(tcfg, device="cpu")
    state = init_train_state(tm, 0, AdamWConfig())
    tree = train_state_to_tree(state, tcfg)
    back = train_state_to_tree(train_state_from_tree(tree, tcfg, device="cpu"), tcfg)
    a, b = _leaf_paths(tree), _leaf_paths(back)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert "['params']/['dec_blocks']/['cross_attn']/['wq']/['w']" in dict(a)
    assert tuple(dict(a)["['params']/['enc_blocks']/['norm1']/['scale']"].shape) == (tcfg.n_enc_layers, tcfg.d_model)
    for (key, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), key


def test_chip_smoke_whisper_traffic_on_cpu():
    """chip_smoke.py's phase-9 Whisper traffic at a tiny size on the CPU:
    the caller pads the prefill's self caches, decodes to the end of the
    text context, and the fresh prefill is the check."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=torch.bfloat16)
    m = build_model(cfg, device="cpu")
    _, _, frames, toks = _inputs(6, cfg, 40, 32, "bfloat16", batch=1)
    out = chip_smoke.family_traffic(m, m.init(0), toks.long(), 28, 0, frames=frames)
    assert out["decode_vs_prefill_rel_err"] < 0.05
    assert tuple(out["caches"]["self"]["k"].shape) == (cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
