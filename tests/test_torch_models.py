"""The port's dense decoder (reduced Qwen2.5-32B) held against the JAX
package's, on the CPU.

The JAX side builds its parameters (``init_decoder`` from a PRNG key); the
same values reach the port through ``params_from_numpy``. Prefill logits
and caches and ``decode_step`` logits must agree within the reference's
tolerances: 2e-4 with float32 parameters, 3e-2 with bfloat16 ones
(``tests/test_flash_attn_kernel.py:46,58``). Token inputs come from seeded
numpy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import zeros_from_specs

ARCH = "qwen2.5-32b"
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def numpy_tree(params):
    """A JAX parameter tree as numpy leaves, bfloat16 as its uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, params)


def pair(dtype: str = "float32", seed: int = 0, **overrides):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=_TORCH[dtype], **overrides)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(numpy_tree(jp), tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, dtype):
    np.testing.assert_allclose(_np(a), _np(b), rtol=TOL[dtype], atol=TOL[dtype])


def _tokens(seed: int, shape, vocab: int):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, attn_impl):
    jm, jp, tm, tp = pair(dtype, attn_impl=attn_impl, attn_q_chunk=8, attn_kv_chunk=8)
    toks = _tokens(0, (2, 16), tm.cfg.vocab)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=24)
    assert tl.shape == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    _close(tl, jl, dtype)
    for name in ("k", "v"):
        assert tuple(tc[0][0][name].shape) == jc[0][0][name].shape
        _close(tc[0][0][name], jc[0][0][name], dtype)
    nxt = _tokens(1, (2, 1), tm.cfg.vocab)
    jl2, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(16))
    tl2, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), 16)
    _close(tl2, jl2, dtype)


def test_prefill_decode_consistency():
    """tests/test_models.py's check on the port: prefill 16 then decode 8
    gives the last logits of a 24-token prefill."""
    tcfg = get_config(ARCH).reduced()
    m = build_model(tcfg, device="cpu")
    params = m.init(1)
    toks = torch.from_numpy(_tokens(0, (2, 24), tcfg.vocab))
    _, caches = m.prefill(params, {"tokens": toks[:, :16]}, cache_len=24)
    lg = None
    for t in range(16, 24):
        lg, caches = m.decode_step(params, caches, toks[:, t : t + 1], t)
    ref, _ = m.prefill(params, {"tokens": toks}, cache_len=24)
    a, b = lg[:, 0].float(), ref[:, 0].float()
    assert float((a - b).abs().max() / (b.abs().max() + 1e-6)) < 0.05


def test_dense_vs_chunked_on_the_port():
    cfg_d = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=torch.float32)
    cfg_c = dataclasses.replace(cfg_d, attn_impl="chunked", attn_q_chunk=16, attn_kv_chunk=8)
    md, mc = build_model(cfg_d, device="cpu"), build_model(cfg_c, device="cpu")
    params = md.init(0)
    toks = torch.from_numpy(_tokens(3, (2, 32), cfg_d.vocab))
    ld, cd = md.prefill(params, {"tokens": toks})
    lc, cc = mc.prefill(params, {"tokens": toks})
    _close(lc, ld, "float32")
    _close(cc[0][0]["k"], cd[0][0]["k"], "float32")


def _greedy(model, params, toks, *, torch_side: bool, n: int):
    """Feed ``n`` tokens through decode_step from empty caches; the last logits."""
    if torch_side:
        caches = zeros_from_specs(model.cache_specs(ShapeSpec("d", 32, 2, "decode")), "cpu")
    else:
        cs = model.cache_specs(JShapeSpec("d", 32, 2, "decode"))
        caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cs,
                              is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    lg = None
    for t in range(n):
        if torch_side:
            lg, caches = model.decode_step(params, caches, torch.from_numpy(toks[:, t : t + 1]), t)
        else:
            lg, caches = model.decode_step(params, caches, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
    return _np(lg[:, 0])


@pytest.mark.parametrize("dtype,weight_quant,kv_cache_quant", [
    ("float32", True, False), ("float32", False, True), ("float32", True, True), ("bfloat16", True, False),
])
def test_quantized_modes_match_jax(dtype, weight_quant, kv_cache_quant):
    """w8a16 weights (int8 + per-layer scale, carried across as they are)
    and the int8 KV cache, against the JAX package's modes. float32
    activations with the int8 cache: in bfloat16 the two frameworks round
    k and v differently before the cache quantizes them, and one value that
    lands on the other side of a rounding step moves a logit by more than
    3e-2."""
    jm, jp, tm, tp = pair(dtype, weight_quant=weight_quant, kv_cache_quant=kv_cache_quant)
    if weight_quant:
        assert tp.blocks[0].attn.wq.w.dtype == torch.int8 and tp.lm_head.w.dtype == torch.int8
    toks = _tokens(4, (2, 16), tm.cfg.vocab)
    a = _greedy(jm, jp, toks, torch_side=False, n=16)
    b = _greedy(tm, tp, toks, torch_side=True, n=16)
    _close(b, a, dtype)


def test_port_quantizer_matches_jax():
    """The port's ``quantize_dense_weights`` gives the JAX package's int8
    weights and scales on the same bfloat16 weights."""
    from repro.models.layers import quantize_dense_weights as jquant
    from repro_torch.models.layers import quantize_dense_weights as tquant

    _, jp, _, tp = pair("bfloat16")
    jq = numpy_tree(jquant(jp))
    tq = params_to_numpy(tquant(tp), get_config(ARCH).reduced())
    for path in (("blocks", 0, "attn", "wq"), ("blocks", 0, "ffn", "down"), ("lm_head",)):
        j, t = jq, tq
        for p in path:
            j, t = j[p], t[p]
        np.testing.assert_array_equal(t["w"], j["w"])
        np.testing.assert_array_equal(t["w_scale"], j["w_scale"])


@pytest.mark.parametrize("weight_quant", [False, True])
def test_params_round_trip(weight_quant):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), weight_quant=weight_quant)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), weight_quant=weight_quant)
    tree = numpy_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(5)))
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"), tcfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_layout_matches_jax_tree():
    """The port's own init builds the tree the JAX package builds: same
    keys, shapes and dtypes."""
    tcfg = get_config(ARCH).reduced()
    tree = params_to_numpy(build_model(tcfg, device="cpu").init(0), tcfg)
    jspec = jbuild_model(jget_config(ARCH).reduced()).param_specs()
    flat_t, def_t = jax.tree.flatten(tree)
    flat_j, def_j = jax.tree.flatten(jspec)
    assert def_t == def_j
    for t, j in zip(flat_t, flat_j):
        assert t.shape == j.shape
        assert t.dtype == (np.uint16 if j.dtype == jnp.bfloat16 else j.dtype)


def test_w8_halves_weight_bytes():
    cfg = get_config(ARCH).reduced()
    size = lambda m: sum(p.numel() * p.element_size() for p in m.init(0).parameters())
    assert size(build_model(dataclasses.replace(cfg, weight_quant=True), device="cpu")) < \
        0.65 * size(build_model(cfg, device="cpu"))


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(ARCH).reduced())


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if set(ARCHS[a].block_pattern) != {"attn_global"} or ARCHS[a].enc_dec))
def test_kinds_of_later_slices_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(arch).reduced(), device="cpu")
