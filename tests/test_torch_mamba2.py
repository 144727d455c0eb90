"""The port's Mamba-2 (reduced Mamba2-1.3B: the SSD chunked scan) held
against the JAX package's, on the CPU.

The JAX side builds the parameters and the same values reach the port
through ``params_from_numpy`` (or its train-state twin); inputs come from
seeded numpy. Outputs agree within the reference's tolerances: 2e-4 with
float32 parameters, 3e-2 with bfloat16 ones
(``tests/test_flash_attn_kernel.py:46,58``).

The reference's gradient is NaN wherever a masked within-chunk decay
overflows (``jnp.where(tri, exp(...), 0)`` passes the cotangent 0 times
``inf`` back), which its own init reaches even at chunk 8; the port masks
the exponent and stays finite. So the tests that compare gradients or
train steps first set every ``a_log`` (``calm``) so that no decay
overflows, in both packages alike.
"""

import dataclasses
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
from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import DedupCheckpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.loop import build_train_step as jbuild_train_step
from repro.train.loop import init_train_state as jinit_train_state
from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLMData
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
import chip_smoke  # noqa: E402  (phase 9's traffic)

ARCH = "mamba2-1.3b"
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


def _cfgs(dtype: str = "float32", **overrides):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=_JNP[dtype], **overrides)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=_TORCH[dtype], **overrides)
    return jcfg, tcfg


def calm(tree):
    """A JAX parameter or train-state tree with every ``a_log`` (the
    parameters and the fp32 master; not the moments) at log(0.05..0.5), so
    that no masked decay overflows in a reduced model's chunks."""
    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] != "a_log" or {"mu", "nu", "err"} & set(keys):
            return x
        return jnp.broadcast_to(jnp.log(jnp.linspace(0.05, 0.5, x.shape[-1])), x.shape).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def pair(dtype: str = "float32", seed: int = 0, calm_decay: bool = False, **overrides):
    """(JAX model, JAX params, port model, port params) with equal weights."""
    jcfg, tcfg = _cfgs(dtype, **overrides)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    if calm_decay:
        jp = calm(jp)
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(numpy_tree(jp), tcfg, device="cpu")


def _tokens(seed: int, shape, vocab: int):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _flat(tree):
    """Leaves of a (JAX or port) cache tree in the JAX flattening order."""
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


# ------------------------------------------------------------ the mixer ---
def _mamba_pair(dtype: str, seed: int = 0, **spec_kw):
    """A Mamba-2 mixer in both packages with equal weights: the JAX
    ``init_mamba`` with non-zero ``dt_bias`` and ``conv_b``, carried into
    the port through a one-block tree."""
    kw = {"d_model": 32, "d_state": 16, "head_dim": 16, "chunk": 8, **spec_kw}
    jspec, tspec = jssm.MambaSpec(**kw), tssm.MambaSpec(**kw)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jspec, _JNP[dtype])
    rng = np.random.default_rng(seed)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(jspec.n_heads) * 0.5, jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(jspec.conv_channels) * 0.1, _JNP[dtype]))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=1, d_model=32)
    blk = params_from_numpy({"blocks": (), "tail": ({"norm1": {"scale": np.ones(32, np.float32)},
                                                     "mixer": numpy_tree(jp)},),
                             "embed": {"table": np.zeros((1, 32), np.float32)},
                             "final_norm": {"scale": np.ones(32, np.float32)}},
                            dataclasses.replace(cfg, block_pattern=("mamba2", "mamba2")), device="cpu").tail[0]
    return jspec, jp, tspec, blk.mixer


def _u(seed: int, shape, dtype: str):
    u = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(u).astype(_JNP[dtype]), torch.from_numpy(u).to(_TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_and_decode_match_jax(dtype):
    """A 40-position prefill (5 chunks) with its (state, conv) cache, then 2
    decode steps from it: outputs and caches, the caches updated in place."""
    jspec, jp, tspec, tp = _mamba_pair(dtype)
    assert tp.a_log.dtype == tp.dt_bias.dtype == tp.d_skip.dtype == torch.float32
    assert tp.conv_w.dtype == tp.norm_scale.dtype == _TORCH[dtype]
    ju, tu = _u(1, (2, 40, 32), dtype)
    jy, (jh, jconv) = jax.jit(lambda p, u: jssm.mamba_prefill(p, jspec, u, True))(jp, ju)
    ty, (th, tconv) = tssm.mamba_prefill(tp, tspec, tu, True)
    assert th.dtype == torch.float32 and tuple(th.shape) == (2, tspec.n_heads, 16, 16)
    assert tconv.dtype == _TORCH[dtype] and tuple(tconv.shape) == (2, 3, tspec.conv_channels)
    for t, j in ((ty, jy), (th, jh), (tconv, jconv)):
        _close(t, j, dtype)
    assert torch.equal(tssm.mamba_prefill(tp, tspec, tu), ty)  # the cache changes nothing
    h, conv = th.clone(), tconv.clone()
    jdecode = jax.jit(lambda p, x, h, c: jssm.mamba_decode(p, jspec, x, h, c))
    for step in range(2):
        jx, tx = _u(10 + step, (2, 1, 32), dtype)
        jy, jh, jconv = jdecode(jp, jx, jh, jconv)
        ty, th2, tconv2 = tssm.mamba_decode(tp, tspec, tx, h, conv)
        assert th2 is h and tconv2 is conv  # updated in place
        for t, j in ((ty, jy), (h, jh), (conv, jconv)):
            _close(t, j, dtype)


def test_mamba_decode_continues_its_prefill():
    """Prefill 24 positions, then decode 16 from its cache: the outputs are
    those of a 40-position prefill (5 chunks)."""
    _, _, spec, p = _mamba_pair("float32")
    u = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 40, 32)).astype(np.float32))
    full = tssm.mamba_prefill(p, spec, u)
    _, (h, conv) = tssm.mamba_prefill(p, spec, u[:, :24], True)
    for t in range(24, 40):
        y, _, _ = tssm.mamba_decode(p, spec, u[:, t : t + 1], h, conv)
        torch.testing.assert_close(y, full[:, t : t + 1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sl", [7, 12, 41])
def test_mamba_prefill_raises_off_the_chunk(sl):
    """The reference asserts S % chunk == 0; the port raises ValueError."""
    _, _, spec, p = _mamba_pair("float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.mamba_prefill(p, spec, torch.zeros((1, sl, 32)))


def test_mamba_full_width_chunk_overflow_has_no_nan():
    """Chunk 128 at a reduced width: above the diagonal, exp(cum_i - cum_j)
    overflows (the decay falls by dt * 16 a position on the last head).
    The output has no NaN and meets the reference's; so does the port's
    gradient, whose exponent is masked before exp."""
    jspec, jp, tspec, tp = _mamba_pair("float32", chunk=128)
    ju, tu = _u(4, (1, 256, 32), "float32")
    z, x, bb, cc, dt_raw = tssm._split_proj(tspec, tssm.dense(tp.in_proj, tu))
    loga = torch.nn.functional.softplus(dt_raw + tp.dt_bias) * -torch.exp(tp.a_log)
    assert float(-loga.reshape(2, 128, -1).sum(dim=1).max()) > 89  # exp(89) overflows float32
    jy = jax.jit(lambda p, u: jssm.mamba_prefill(p, jspec, u))(jp, ju)
    tu.requires_grad_(True)
    ty = tssm.mamba_prefill(tp, tspec, tu)
    assert bool(torch.isfinite(ty).all()) and np.isfinite(np.asarray(jy)).all()
    _close(ty, jy, "float32")
    (g,) = torch.autograd.grad(ty.square().sum(), tu)
    assert bool(torch.isfinite(g).all())


# ----------------------------------------------------------- full models ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A 24-position prefill (3 chunks) and 2 decode steps: the logits, and
    every cache leaf (layer 0's in bfloat16)."""
    jm, jp, tm, tp = pair(dtype)
    toks = _tokens(0, (2, 24), tm.cfg.vocab)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, {"tokens": jnp.asarray(toks)}, 28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=28)
    assert tl.shape == (2, 1, tm.cfg.padded_vocab) and tl.dtype == _TORCH[dtype]
    _close(tl, jl, dtype)
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
        _close(tl, jl, dtype)
    check_caches()


def test_prefill_decode_consistency():
    """The mamba case of tests/test_models.py's check on the port: 8 decode
    steps after a 16-position prefill give the last logits of a fresh
    24-position prefill."""
    cfg = get_config(ARCH).reduced()
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


def test_cache_specs_and_decode_from_empty_caches_match_jax():
    """``cache_specs`` (the fp32 state, the conv window in the model dtype),
    then 12 decode steps from zeros in both packages."""
    jm, jp, tm, tp = pair()
    shape, jshape = ShapeSpec("d", 48, 2, "decode"), JShapeSpec("d", 48, 2, "decode")
    jspecs = jm.cache_specs(jshape)
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tleaves = jax.tree.leaves(tm.cache_specs(shape), is_leaf=lambda x: isinstance(x, tT.TensorSpec))
    assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in tleaves] == \
        [(j.shape, j.dtype.name) for j in jleaves]
    tc = tT.zeros_from_specs(tm.cache_specs(shape), "cpu")
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspecs,
                      is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    jdecode = jax.jit(jm.decode_step)
    toks = _tokens(4, (2, 12), tm.cfg.vocab)
    for t in range(12):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t : t + 1]), t)
    _close(tl, jl, "float32")


# ------------------------------------------------------- loss and grads ---
def _batch(cfg, seed: int, batch: int = 2, seq: int = 24) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    out["labels"][:, :3] = -1
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_jax(dtype):
    jm, jp, tm, tp = pair(dtype, calm_decay=True)
    batch = _batch(tm.cfg, 1)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(met["aux_loss"]) == 0.0
    named = dict(tp.named_parameters())
    grads = _tree_of_named(dict(zip(named, torch.autograd.grad(total, list(named.values())))), tm.cfg)
    _close(total, jtotal, dtype)
    t_leaves = _leaf_paths(grads)
    j_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in t_leaves] == ["/".join(str(p) for p in path) for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j)), key
        _close(t, j, dtype)


def test_reference_gradient_is_nan_where_the_masked_decay_overflows():
    """At the reference's own init the reduced model's chunks overflow the
    masked decay: the JAX gradient holds NaN, the port's is finite, and
    the two losses agree."""
    jm, jp, tm, tp = pair()
    batch = _batch(tm.cfg, 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jgrads))
    total, _ = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, list(tp.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _close(total, jloss, "float32")


# ------------------------------------------------------ parameter trees ---
@pytest.mark.parametrize("weight_quant", [False, True])
def test_params_round_trip(weight_quant):
    jcfg, tcfg = _cfgs("bfloat16", weight_quant=weight_quant)
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
    keys, shapes and dtypes (a_log, dt_bias, d_skip in float32)."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = params_to_numpy(build_model(tcfg, device="cpu").init(0), tcfg)
    flat_t, def_t = jax.tree.flatten(tree)
    flat_j, def_j = jax.tree.flatten(jbuild_model(jcfg).param_specs())
    assert def_t == def_j
    for t, j in zip(flat_t, flat_j):
        assert t.shape == j.shape
        assert t.dtype == (np.uint16 if j.dtype == jnp.bfloat16 else j.dtype)


def test_train_state_tree_round_trip_and_leaf_keys():
    jcfg, tcfg = _cfgs("bfloat16")
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


def test_jax_mamba2_checkpoint_resumes_in_the_port():
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    js = calm(jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT)))
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=3)
    step = jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT)))
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


def test_port_mamba2_checkpoint_resumes_in_jax():
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    js0 = calm(jinit_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**OPT)))
    ts = train_state_from_tree(numpy_tree(js0), tcfg, device="cpu")
    data = SyntheticLMData(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=4)
    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 64 * 1024))
    ts, _ = train_loop(tm, data, TrainConfig(steps=2, checkpoint_every=2, opt=AdamWConfig(**OPT)),
                       checkpointer=DedupCheckpointer(tc, device="cpu"), state=ts)
    jstate = JCheckpointer(tc).restore("step-2", like=js0)
    js3, jmet = _jax_steps(jax.jit(jbuild_train_step(jm, JAdamWConfig(**OPT))), jstate, data, [2])
    ts3, tmet = build_train_step(tm, AdamWConfig(**OPT))(ts, {k: torch.from_numpy(v) for k, v in data.batch(2).items()})
    _close(tmet["total_loss"], jmet["total_loss"], "float32")
    _assert_state_close(ts3, js3, tcfg)


# ------------------------------------------------------------- launcher ---
def test_train_launcher_prints_the_jax_lines(capsys, monkeypatch):
    """The launcher's step lines equal the reference's up to the losses and
    seconds (the checkpoint lines are held in test_torch_train.py). The
    reference's loss turns NaN after its first update (its NaN gradient,
    above), the port's stays finite: a loss is masked either way."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--arch", ARCH, "--steps", "4", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    mask = lambda text: [re.sub(r"\d+\.\d+|nan", "#", line) for line in text.splitlines()]
    assert mask(got) == mask(want) == ["step     0 loss # (#s)", "step     3 loss # (#s)"]


# ------------------------------------------------ chip_smoke.py phase 9 ---
def test_chip_smoke_mamba2_traffic_on_cpu():
    """chip_smoke.py's phase-9 Mamba2 traffic at a tiny size on the CPU:
    prefill a multiple of the chunk, decode 16 steps, and the fresh prefill
    it is held against (float32: within 2e-4); no flash launches."""
    _, cfg = _cfgs()
    model = build_model(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(6, (1, 40), cfg.vocab)).long()
    out = chip_smoke.family_traffic(model, model.init(0), tokens, 24, 40)
    assert out["flash_launches"] == {"prefill": 0, "prefill_windowed": 0, "decode": 0}
    assert out["decode_vs_prefill_rel_err"] < 2e-4
    state = out["caches"][0][0]["state"]
    assert state.dtype == torch.float32 and tuple(state.shape) == (cfg.n_layers, 1, 16, 16, 16)
