"""The flash kernel's backward on the CPU: its plain twins against the JAX
package, the autograd wiring, and training through ``attn_impl="chunked"``.

- ``ref.flash_attention_lse_plain`` / ``ref.flash_attention_bwd_plain``
  (the twins the CUDA kernels are held to on the card) against ``jax.vjp``
  of the JAX package's ``chunked_attention`` and a JAX log-sum-exp, and
  against torch autograd through ``flash_attention_plain``: float32, 2e-4,
  over causal / window / non-causal, GQA, Sq != Skv, ragged lengths, rows
  that see no key and dqk != dv.
- ``flash_attn.FlashAttention`` (the Function the card trains through) by
  ``torch.autograd.gradcheck`` in float64, and its launches under each
  ``remat`` mode: the forward once (``"none"``) or twice (``"full"``,
  ``"dots"``: recomputed), the backward once.
- The port's loss and gradients with ``attn_impl="chunked"`` against
  ``jax.value_and_grad`` of the JAX model with ``attn_impl="chunked"``:
  reduced Qwen2.5-32B, LLaVA-NeXT with ``patch_embeds``, Gemma3-12B
  (window) and MiniCPM3-4B, float32 within 2e-4, under ``remat="full"``
  and ``"dots"``.
- ``chip_smoke.py``'s phase 4e at a tiny size.
"""

import dataclasses
import math
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
from jax.scipy.special import logsumexp

from repro.models.layers import chunked_attention as jchunked_attention
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import FlashAttention, flash_attention_cuda, flash_attention_plain
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_train import _assert_trees_close, _batch, _close, _grads_tree, _jax, _states  # noqa: E402

# (B, Sq, Skv, H, K, dqk, dv, causal, window)
CASES = [
    (2, 20, 20, 4, 2, 16, 16, True, 0),
    (1, 24, 24, 4, 1, 16, 16, True, 5),
    (2, 12, 20, 4, 4, 16, 16, False, 0),
    (1, 20, 12, 4, 2, 16, 16, True, 0),
    (1, 12, 20, 4, 2, 16, 16, True, 0),
    (1, 13, 13, 2, 1, 8, 8, True, 3),
    (1, 16, 16, 4, 4, 24, 16, True, 0),
    (1, 30, 10, 2, 1, 8, 8, True, 4),   # queries past 12 see no key
    (2, 17, 9, 6, 2, 24, 16, False, 0),
]


def _inputs(case, seed: int = 0, dtype=np.float32):
    b, sq, skv, h, kh, dqk, dv, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((b, sq, h, dqk), (b, skv, kh, dqk), (b, skv, kh, dv), (b, sq, h, dv))]


def _jax_reference(case, q, k, v, dout):
    """(out, lse, dq, dk, dv) of the JAX package's chunked_attention."""
    b, sq, skv, h, kh, dqk, dv, causal, window = case
    scale = 1.0 / math.sqrt(dqk)

    def attn(q, k, v):
        qg = q.reshape(b, sq, kh, h // kh, dqk)
        o = jchunked_attention(qg, k, v, causal=causal, window=window, mask_offset=0, q_chunk=sq, kv_chunk=skv,
                               scale=scale)
        return o.reshape(b, sq, h, dv)

    out, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv_ = vjp(jnp.asarray(dout))
    qg = jnp.asarray(q).reshape(b, sq, kh, h // kh, dqk)
    s = jnp.einsum("bqkrd,bskd->bkrqs", qg, jnp.asarray(k)) * scale
    qi, ki = jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]
    ok = jnp.ones((sq, skv), bool)
    if causal:
        ok = ok & (ki <= qi)
    if window:
        ok = ok & (ki > qi - window)
    lse = logsumexp(jnp.where(ok, s, -jnp.inf), axis=-1).reshape(b, h, sq)
    return [np.asarray(x) for x in (out, lse, dq, dk, dv_)]


def _allclose(got, exp, what: str):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[1]}x{c[2]}-h{c[3]}k{c[4]}-d{c[5]}v{c[6]}-c{int(c[7])}w{c[8]}"
                                             for c in CASES])
def test_plain_twins_match_jax_vjp_and_torch_autograd(case):
    q, k, v, dout = _inputs(case)
    causal, window = case[7], case[8]
    jout, jlse, jdq, jdk, jdv = _jax_reference(case, q, k, v, dout)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = ref.flash_attention_lse_plain(tq, tk, tv, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (case[0], case[3], case[1])
    _allclose(out, jout, "out")
    _allclose(lse, jlse, "lse")  # -inf where a row sees no key, on both sides
    grads = ref.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal, window=window)
    for name, g, j in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert g.dtype == torch.float32 and tuple(g.shape) == j.shape, name
        _allclose(g, j, name)
    # torch autograd through the plain forward route
    aq, ak, av = (x.clone().requires_grad_() for x in (tq, tk, tv))
    plain = flash_attention_plain(aq, ak, av, causal=causal, window=window)
    for name, g, a in zip(("dq", "dk", "dv"), grads, torch.autograd.grad(plain, (aq, ak, av), tdo)):
        _allclose(g, a.numpy(), f"{name} against autograd")


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[7], CASES[8]], ids=["window", "noncausal", "empty_rows",
                                                                              "dv_ne_dqk"])
def test_function_passes_gradcheck_in_float64(case):
    """The autograd Function on CPU float64 tensors (its twins compute in
    float64 there) against finite differences, at a tiny size."""
    b, sq, skv, h, kh, dqk, dv, causal, window = case
    q, k, v, _ = _inputs((b, min(sq, 9), min(skv, 7), h, kh, dqk, dv, causal, window), 1, np.float64)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, 0.3), args)


def test_wrapper_under_grad_goes_through_the_function():
    """Under grad ``flash_attention_cuda`` is differentiable through the
    Function (its plain twins on the CPU), and refuses ``return_lse``;
    without grad a CPU tensor takes the plain routes."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    q.requires_grad_()
    out = flash_attention_cuda(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out, q, dout)
    _, lse = ref.flash_attention_lse_plain(q.detach(), k, v)
    np.testing.assert_allclose(dq.numpy(), ref.flash_attention_bwd_plain(
        q.detach(), k, v, out.detach(), lse, dout)[0].numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention_cuda(q, k, v, return_lse=True)
    with torch.no_grad():
        o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True)
        assert torch.equal(lse2, lse)
        assert flash_attention_cuda(q, k, v).grad_fn is None


@pytest.mark.parametrize("remat,forward", [("none", 1), ("full", 2), ("dots", 2)])
def test_function_launches_under_each_remat_mode(monkeypatch, remat, forward):
    """Under ``_remat`` the Function's forward runs once ("none") or twice
    ("full", and "dots": it is no saved product), its backward once; the
    gradients are those of the un-checkpointed function."""
    calls = {"forward": 0, "backward": 0}
    lse_plain, bwd_plain = ref.flash_attention_lse_plain, ref.flash_attention_bwd_plain

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ref, "flash_attention_lse_plain", counted("forward", lse_plain))
    monkeypatch.setattr(ref, "flash_attention_bwd_plain", counted("backward", bwd_plain))
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((16, 48)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 10, 16)).astype(np.float32))

    def block(x, w):
        qkv = (x @ w).reshape(2, 10, 6, 8)
        return flash_attention_cuda(qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]).sum()

    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), remat=remat)
    (g,) = torch.autograd.grad(T._remat(cfg, block)(x, w), w)
    assert calls == {"forward": forward, "backward": 1}
    monkeypatch.undo()
    (g_ref,) = torch.autograd.grad(block(x, w), w)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=0)


# ------------------------------------------- the model through "chunked" ---
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen", "llava", "gemma3", "minicpm3"])
def test_chunked_loss_and_grads_match_jax(arch, remat):
    """The port's loss and every gradient leaf with attn_impl="chunked"
    against ``jax.value_and_grad`` of the JAX model with "chunked" (query
    and kv chunks of 8), float32 within 2e-4."""
    jm, js, tm, ts = _states(arch, "float32", attn_impl="chunked", attn_q_chunk=8, attn_kv_chunk=8, remat=remat)
    batch = _batch(tm.cfg, 1, ignore=True)
    (jtotal, _), jgrads = jax.value_and_grad(jax.jit(jm.loss_fn), has_aux=True)(js["params"], _jax(batch))
    total, _, grads = _grads_tree(tm, ts["params"], batch)
    _close(total, jtotal, "float32")
    _assert_trees_close(grads, jgrads, "float32")


def test_step_categories_put_the_flash_kernels_under_attention():
    """The kernels are no aten operations: the profiler gives their device
    time to the Function's forward and backward (``FlashAttention``,
    ``FlashAttentionBackward``), and what runs under them or under the
    wrappers' ranges (buffers, dO's copy) goes to attention with them,
    whatever its shape. LLaVA-NeXT's d_model is S (4,096): its
    activations and weights are no dense scores."""
    from test_torch_train_families import _Event

    cats = chip_smoke.step_categories(get_config("llava-next-mistral-7b"))
    for name in ("FlashAttention", "FlashAttentionBackward", "flash_attention_cuda", "flash_attention_bwd_cuda"):
        for e in (_Event(name), _Event("aten::empty", [(1, 32, 4096)], _Event(name)),
                  _Event("aten::copy_", [(1, 4096, 32, 128)], _Event("aten::contiguous", [], _Event(name)))):
            assert chip_smoke.op_category(e, cats) == "attention (flash kernels)"
    for shapes, want in (
        ([(32, 4096, 4096), (32, 4096, 128)], "attention (dense scores)"),
        ([(1, 8, 4, 4096, 4096), (4096, 4096)], "attention (dense scores)"),
        ([(1, 4096, 4096), (4096, 4096)], "other"),
        ([(4096, 4096), (4096, 14336)], "other"),
    ):
        assert chip_smoke.op_category(_Event("aten::mm", shapes), cats) == want, shapes
    assert "attention (flash kernels)" not in [c[0] for c in chip_smoke.step_categories(get_config("mamba2-1.3b"))]


def test_flash_bwd_bound_at_llava_train_shape():
    """2 (3 dqk + 2 dv) FLOP a visible pair and head: 3.44e11 at
    LLaVA-NeXT's train shape, 0.348 ms at 989 TFLOP/s; the bytes ~1/7 of that."""
    q = torch.empty((1, 4096, 32, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 4096, 8, 128), dtype=torch.bfloat16, device="meta")
    ops_ms, bytes_ms = chip_smoke.flash_bwd_bound_ms(q, kv, kv, True, 0)
    pairs = 4096 * 4097 // 2
    assert ops_ms == pytest.approx(2 * 640 * 32 * pairs / 989e12 * 1e3)
    assert ops_ms == pytest.approx(0.348, abs=1e-3) and ops_ms / 8 < bytes_ms < ops_ms / 6


# --------------------------------------------------- phase 4e on the CPU ---
def _tiny_chunked(dtype=torch.float32, layers: int = 2):
    cfg = dataclasses.replace(get_config(chip_smoke.TRAIN_ARCH).reduced(), n_layers=layers, attn_impl="chunked",
                              remat="full", param_dtype=dtype)
    return cfg, build_model(cfg, device="cpu"), build_model(dataclasses.replace(cfg, attn_impl="dense"), device="cpu")


def test_chip_smoke_chunked_train_traffic_on_cpu():
    """chip_smoke.py's phase 4e traffic on reduced LLaVA-NeXT on the CPU:
    step 0 through chunked and dense agree, three chunked steps and a
    dense one run one ``train_loop`` call each with the flash counts read
    around them (0 here: the CPU route launches no kernel)."""
    cfg, model, dense = _tiny_chunked()
    n_front = cfg.n_frontend_tokens
    data = chip_smoke.PatchedLMData(SyntheticLMData(vocab=cfg.vocab, seq_len=40 - n_front, global_batch=2, seed=0),
                                    n_front, cfg.d_model, cfg.param_dtype, model.device, 0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, 0, opt)
    state, line = chip_smoke.chunked_train_traffic(model, dense, data, opt, state, lambda: None)
    assert [r["step"] for r in line["steps"]] == [0, 1, 2] and line["dense_step"]["step"] == 3
    assert all(r["flash_launches"] == {"forward": 0, "backward": 0} for r in line["steps"])
    assert int(state["opt"]["step"]) == 4
    assert line["step0"]["loss_rel_err"] < 1e-5 and line["step0"]["grad_rel_err_max"] < 1e-4
    assert len(line["step0"]["grad_rel_err_by_leaf"]) == len(list(state["params"].parameters()))


def test_chip_smoke_chunked_grad_check_on_cpu_and_its_fault(monkeypatch):
    """Phase 4e's float32 check (c) passes chunked against dense and fails
    a chunked route whose attention loses a key."""
    from repro_torch.models import layers

    cfg, model, dense = _tiny_chunked(layers=1)
    params = model.init(0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (1, 25))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
             "patch_embeds": torch.from_numpy(rng.standard_normal((1, cfg.n_frontend_tokens, cfg.d_model))
                                              .astype(np.float32))}
    got = chip_smoke.chunked_grad_check(model, dense, params, batch)
    assert got["leaves"] == len(list(params.parameters())) and got["grad_max_abs_err"] < 2e-4

    sound = layers.chunked_attention

    def dropped(qg, k, v, **kw):  # every query loses the first key
        return sound(qg, k[:, 1:], v[:, 1:], **kw)

    monkeypatch.setattr(layers, "chunked_attention", dropped)
    with pytest.raises(AssertionError, match="float32"):
        chip_smoke.chunked_grad_check(model, dense, params, batch)
