"""The optimizer's two routes: the eager per-leaf passes (leaves off the
card) and the CUDA kernels of ``csrc/adamw.cu`` (plain CUDA leaves).

On the CPU a twin of the kernel's per-element update, written in numpy
float32 with one rounding an operation in the kernel's order, is held
bitwise to ``adamw_update``'s plain route: it pins the order the kernel
follows. On the card (``cuda``-marked, skipped here; no JAX) the kernel
route is held bitwise to the plain route given the same clip factor, the
norm kernel to itself over repeats and to the plain norm within 1e-6, a
train step of a reduced LLaVA-NeXT to the kernel route for every leaf, and
DTensor leaves on the card and leaves split between devices are refused:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw.py
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw, adamw_init, adamw_update  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CPU_SHAPES = [(1,), (7,), (4095,), (4096,), (4097,), (257, 4096)]
# LLaVA-NeXT's embedding and head are 32,064 x 4,096
CARD_SHAPES = [(1,), (7,), (4095,), (4096,), (4097,), (32064, 4096)]
CASES = [(p, g, c) for p in DTYPES for g in DTYPES for c in (False, True)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cfg(compress: bool) -> AdamWConfig:
    return AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, compress_grads=compress)


def _grads(shape, dtype, device, seed: int = 0):
    """Three steps' gradients: a norm of 5 on the first (clipped at
    grad_clip 1), 0.2 on the others (not clipped)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for norm in (5.0, 0.2, 0.2):
        g = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
        out.append((g * (norm / torch.linalg.vector_norm(g))).to(dtype))
    return out


def _param(shape, dtype, device, seed: int = 1):
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(seed), device=device).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ, counted on the tensors' device."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(view) != b.view(view)).sum())


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, rounded to nearest even (finite values)."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16).view(np.int16)


def adamw_apply_twin(g, m, v, w, clip, lr, b1c, b2c, cfg, sqrt=np.sqrt):
    """``csrc/adamw.cu``'s ``adamw_element`` over numpy float32 arrays: each
    line one rounded operation of one element, in the kernel's order, the
    Python-float constants rounded to float32. Returns the new (m, v, w).
    ``sqrt`` is the square root's rounding: numpy's is correctly rounded, as
    the kernel's ``__fsqrt_rn`` and the card's ``torch.sqrt`` are."""
    f = np.float32
    b1, c1, b2, c2, eps, wd = (f(x) for x in (cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay))
    clip, lr, b1c, b2c = f(clip), f(lr), f(b1c), f(b2c)
    g = g * clip
    m = m * b1
    m = m + c1 * g
    v = v * b2
    v = v + (c2 * g) * g
    den = sqrt(v / b2c)
    den = den + eps
    u = (m / b1c) / den
    u = u + wd * w
    w = w - lr * u
    return m, v, w


def _cpu_sqrt(x: np.ndarray) -> np.ndarray:
    return torch.sqrt(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=_ids(CPU_SHAPES))
@pytest.mark.parametrize("pdt,gdt,compress", CASES)
def test_kernel_order_twin_is_bitwise_the_plain_update(pdt, gdt, compress, shape):
    """Three steps (clipped, then not) of the plain route on the CPU against
    the twin: mu, nu, master and the parameter bitwise equal after each.
    The twin takes the CPU's ``torch.sqrt``, which its vectorized kernel
    rounds one ulp off in some elements (25 of 4,095 at the update's
    magnitudes on an AVX-512 build); every other operation is numpy's."""
    cfg = _cfg(compress)
    params = {"w": _param(shape, DTYPES[pdt], "cpu")}
    state = adamw_init(params, cfg)
    m = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    w = params["w"].float().numpy().copy()
    err = torch.zeros(shape, dtype=torch.float32)
    launches0 = kadamw.adamw_norm_cuda.launches + kadamw.adamw_apply_cuda.launches
    for i, g in enumerate(_grads(shape, DTYPES[gdt], "cpu")):
        params, state, met = adamw_update(params, {"w": g}, state, cfg)
        clip = adamw._clip(met["grad_norm"], cfg)
        assert (float(clip) < 1.0) == (i == 0)
        _, b1c, b2c = adamw._step_scalars(cfg, state["step"])
        g = g.to(torch.float32)
        if compress:
            g, err = adamw._compress(g, err)
        m, v, w = adamw_apply_twin(g.numpy(), m, v, w, clip, met["lr"], b1c, b2c, cfg, sqrt=_cpu_sqrt)
        for name, twin in (("mu", m), ("nu", v), ("master", w)):
            np.testing.assert_array_equal(_bits(state[name]["w"]), twin.view(np.int32), err_msg=f"{name}, step {i}")
        want = w.view(np.int32) if pdt == "f32" else _bf16_bits(w)
        np.testing.assert_array_equal(_bits(params["w"]), want, err_msg=f"param, step {i}")
    assert kadamw.adamw_norm_cuda.launches + kadamw.adamw_apply_cuda.launches == launches0


# ------------------------------------------------------------- the card ---
@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=_ids(CARD_SHAPES))
@pytest.mark.parametrize("pdt,gdt,compress", CASES)
def test_adamw_kernels_on_card_are_bitwise_the_plain_update(cuda, pdt, gdt, compress, shape):
    """Three steps through ``adamw_update`` (the kernel route) against the
    plain per-leaf update on the card given the kernel's clip factor: mu,
    nu, master and the parameter bitwise equal after each step."""
    cfg = _cfg(compress)
    kp = {"w": _param(shape, DTYPES[pdt], cuda)}
    pp = {"w": kp["w"].clone()}
    ks, ps = adamw_init(kp, cfg), adamw_init(pp, cfg)
    norm0, apply0 = kadamw.adamw_norm_cuda.launches, kadamw.adamw_apply_cuda.launches
    for i, g in enumerate(_grads(shape, DTYPES[gdt], cuda)):
        kp, ks, met = adamw_update(kp, {"w": g}, ks, cfg)
        clip = adamw._clip(met["grad_norm"], cfg)
        assert (float(clip) < 1.0) == (i == 0)
        g = g.to(torch.float32)
        if compress:
            g, ps["err"]["w"] = adamw._compress(g, ps["err"]["w"])
        ps["step"] = ps["step"] + 1
        adamw._apply_plain(pp["w"], g, ps["mu"]["w"], ps["nu"]["w"], ps["master"]["w"], clip,
                           *adamw._step_scalars(cfg, ps["step"]), cfg)
        for name in ("mu", "nu", "master") + (("err",) if compress else ()):
            assert _differ(ks[name]["w"], ps[name]["w"]) == 0, f"{name}, step {i}"
        assert _differ(kp["w"], pp["w"]) == 0, f"param, step {i}"
    assert (kadamw.adamw_norm_cuda.launches - norm0, kadamw.adamw_apply_cuda.launches - apply0) == (6, 3)


@pytest.mark.cuda
def test_adamw_apply_on_card_takes_leaves_off_16_byte_boundaries(cuda):
    """A bf16 parameter and its gradient one element into their buffers
    (no 16-byte access fits) take the kernel's scalar loop, bitwise the
    plain update's."""
    cfg = _cfg(False)
    n = 4097
    buf = _param((n + 1,), torch.bfloat16, cuda)
    kp = buf[1:]
    pp = kp.clone()
    ks, ps = adamw_init({"w": kp}, cfg), adamw_init({"w": pp}, cfg)
    for g in _grads((n + 1,), torch.bfloat16, cuda):
        g = g[1:]
        assert kp.data_ptr() % 16 and g.data_ptr() % 16
        _, ks, met = adamw_update({"w": kp}, {"w": g}, ks, cfg)
        ps["step"] = ps["step"] + 1
        adamw._apply_plain(pp, g.float(), ps["mu"]["w"], ps["nu"]["w"], ps["master"]["w"],
                           adamw._clip(met["grad_norm"], cfg), *adamw._step_scalars(cfg, ps["step"]), cfg)
    for name in ("mu", "nu", "master"):
        assert _differ(ks[name]["w"], ps[name]["w"]) == 0, name
    assert _differ(kp, pp) == 0
    assert torch.equal(buf[:1], _param((n + 1,), torch.bfloat16, cuda)[:1])


@pytest.mark.cuda
def test_adamw_apply_on_card_refuses_other_dtypes(cuda):
    cfg = _cfg(False)
    p = torch.zeros(16, dtype=torch.float16, device=cuda)
    state = adamw_init({"w": p}, cfg)
    with pytest.raises(ValueError, match="parameter"):
        adamw_update({"w": p}, {"w": torch.ones(16, device=cuda)}, state, cfg)
    with pytest.raises(ValueError, match="gradients"):
        kadamw.adamw_norm_cuda([torch.ones(16, dtype=torch.float16, device=cuda)], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("gdt", list(DTYPES))
def test_adamw_norm_on_card_repeats_bitwise_and_matches_the_plain_norm(cuda, gdt):
    """LLaVA-NeXT-like leaves (the 32,064 x 4,096 embedding, a 4,096 x
    14,336 projection, odd sizes): five calls give the same bits; gnorm is
    within 1e-6 of the plain norm, and clip is the eager clamp of it."""
    shapes = [(32064, 4096), (4096, 14336), (4096,), (1,), (4097,), (7, 129)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    grads = [(torch.randn(s, device=cuda, generator=gen) * 1e-3).to(DTYPES[gdt]) for s in shapes]
    first = kadamw.adamw_norm_cuda(grads, 1.0)
    launches0 = kadamw.adamw_norm_cuda.launches
    for _ in range(4):
        again = kadamw.adamw_norm_cuda(grads, 1.0)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(again, first))
    assert kadamw.adamw_norm_cuda.launches - launches0 == 4 * (len(shapes) + 1)
    gnorm, clip = first
    plain = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads) + 1e-16)
    assert abs(float(gnorm) / float(plain) - 1.0) < 1e-6, (float(gnorm), float(plain))
    assert float(clip) < 1.0
    assert torch.equal(clip.view(torch.int32), adamw._clip(gnorm, AdamWConfig()).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_llava_train_step_on_card_takes_the_kernels_for_every_leaf(cuda, accum):
    """Two train steps of a reduced bf16 LLaVA-NeXT: every leaf takes the
    kernel route, each step launches 2 kernels a leaf and one more, and
    every master weight moves (accum 1: the bf16 gradients straight from
    autograd; 2: the fp32 accumulation buffers)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.train.loop import build_train_step, init_train_state

    cfg = dataclasses.replace(get_config("llava-next-mistral-7b").reduced(), param_dtype=torch.bfloat16)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, 0, opt)
    named = dict(state["params"].named_parameters())
    before = {n: w.clone() for n, w in state["opt"]["master"].items()}
    step_fn = build_train_step(model, opt, accum=accum)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=2)
    patches = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)).to(cuda)
    for step in range(2):
        batch = {k: torch.as_tensor(v, device=cuda) for k, v in data.batch(step).items()}
        norm0, apply0 = kadamw.adamw_norm_cuda.launches, kadamw.adamw_apply_cuda.launches
        state, metrics = step_fn(state, {**batch, "patch_embeds": patches})
        launches = (kadamw.adamw_norm_cuda.launches - norm0, kadamw.adamw_apply_cuda.launches - apply0)
        assert launches == (len(named) + 1, len(named)), launches
        assert np.isfinite(float(metrics["total_loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert all(p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all()) for p in named.values())
    assert all(not torch.equal(w, before[n]) for n, w in state["opt"]["master"].items())


def test_leaves_off_the_card_take_the_plain_route():
    """CPU leaves and the dry run's meta tensors take the eager passes."""
    cpu = {"w": torch.zeros(4)}
    meta = {"w": torch.zeros(4, device="meta")}
    assert adamw._on_kernels(cpu, cpu) is False
    assert adamw._on_kernels(meta, meta) is False


@pytest.mark.cuda
def test_adamw_update_on_card_refuses_leaves_split_between_devices(cuda):
    """A step with one leaf on the card and one on the CPU raises; neither
    route takes it."""
    cfg = _cfg(False)
    params = {"a": torch.zeros(16, device=cuda), "b": torch.zeros(16)}
    state = adamw_init(params, cfg)
    with pytest.raises(ValueError, match="plain CUDA tensors only"):
        adamw_update(params, {n: torch.ones_like(p) for n, p in params.items()}, state, cfg)


@pytest.mark.cuda
def test_adamw_update_on_card_refuses_dtensor_leaves(cuda):
    """DTensor leaves on the card (a world-1 NCCL group) raise rather than
    take the eager passes: their norm needs a sum across ranks that the
    kernels do not take yet."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        cfg = _cfg(False)
        p = DTensor.from_local(torch.zeros(16, device=cuda), mesh, [Replicate()])
        state = adamw_init({"w": p}, cfg)
        g = DTensor.from_local(torch.ones(16, device=cuda), mesh, [Replicate()])
        with pytest.raises(ValueError, match="DTensor on cuda"):
            adamw_update({"w": p}, {"w": g}, state, cfg)
        assert int(state["step"].full_tensor()) == 0
    finally:
        dist.destroy_process_group()
