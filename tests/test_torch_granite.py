"""Granite-4.0-H-Small in the port, held against the benchmark's plain float32
reference (``bench/families/granitemoehybrid.py``) on the CPU.

The JAX package has no Granite, so the reference here is the HF model's
equations in plain torch. At the family's tiny sizes in float32 on seeded
weights: one microbatch's loss and every leaf's gradient; the dropless route
against a per-token loop, also under the worst skews (every token on one
held expert, every token on experts held elsewhere); the four shares of the
experts adding up to the uncut layer; NoPE attention; the muP scalars and
the gated norm's eps; the registry entry's published sizes.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.families import family  # noqa: E402
from bench.job import program_sizes  # noqa: E402
from bench.reference.train import flat, leaf_names, map_tree  # noqa: E402
from bench.weights import make_batch, make_tree  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import _mamba_spec  # noqa: E402

ARCH = "granite-4.0-h-small"
FAMILY = family("granitemoehybrid")
SEED = 2**31 + 4099
CONFIG = json.loads((ROOT / "bench" / "configs" / "granite-4.0-h-small.d10.json").read_text())


def tiny_model(**over) -> dict:
    m = dict(CONFIG["model"], dtype="float32")
    m.update(FAMILY.TINY, **over)
    return m


def program(m: dict, **over):
    base = get_config(ARCH)
    cfg = dataclasses.replace(base, **program_sizes(m, base), param_dtype=torch.float32, **over)
    model = build_model(cfg, device="cpu")
    return model, params_from_numpy(make_tree(m, "granitemoehybrid", SEED, "cpu"), cfg, "cpu")


def reference(m: dict, batch: dict):
    params = map_tree(lambda t: t.float().requires_grad_(True), make_tree(m, "granitemoehybrid", SEED, "cpu"))
    loss = FAMILY.loss(params, m, batch)
    grads = torch.autograd.grad(loss, flat(params))
    it = iter(grads)
    tree = map_tree(lambda _: next(it), params)
    out = {}
    for name, keys in leaf_names(params):
        t = tree
        for k in keys:
            t = t[k]
        out[name] = t
    return loss.detach(), out


def _batch(m: dict) -> dict:
    return {k: v[:1] for k, v in make_batch(m, SEED, 0, "cpu").items()}


# ------------------------------------------------------------- the model ----
@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_loss_and_every_gradient_equal_the_reference(attn_impl):
    m = tiny_model()
    batch = _batch(m)
    model, params = program(m, attn_impl=attn_impl, attn_q_chunk=8, attn_kv_chunk=8)
    loss, _ = model.loss_fn(params, batch)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ref_loss, ref_grads = reference(m, batch)
    assert torch.allclose(loss.detach(), ref_loss, rtol=1e-5, atol=0)
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        r = ref_grads[name]
        assert g.shape == r.shape, name
        assert (g - r).abs().max() <= 1e-4 * r.abs().max() + 1e-9, name


@pytest.mark.parametrize("over", [dict(embedding_multiplier=3.0), dict(residual_multiplier=0.5),
                                  dict(logits_scaling=4.0), dict(ssm_norm_eps=0.5), dict(attn_scale=2.0)],
                         ids=lambda d: next(iter(d)))
def test_each_mup_scalar_and_the_gated_norm_eps_reach_the_loss_as_in_the_reference(over):
    """Each scalar moved away from its published value moves the port's
    loss as it moves the reference's (the gated norm reads ``ssm_norm_eps``
    in the port and ``norm_eps`` in the reference, which the file keeps
    equal)."""
    m = tiny_model(**over)
    if "ssm_norm_eps" in over:
        m["norm_eps"] = over["ssm_norm_eps"]
    batch = _batch(m)
    model, params = program(m)
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
        ref_loss = FAMILY.loss(map_tree(lambda t: t.float(), make_tree(m, "granitemoehybrid", SEED, "cpu")), m, batch)
        base, base_params = program(tiny_model())
        moved, _ = base.loss_fn(base_params, batch)
    assert torch.allclose(loss, ref_loss, rtol=1e-5, atol=0)
    assert (loss - moved).abs() > 10 * (loss - ref_loss).abs()


def test_a_multiplier_of_one_is_skipped_not_applied():
    """The muP scalars at 1 add no operation: each block's branch then is
    added as it is, as in every architecture that has no such scalar."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    m = tiny_model()
    batch = _batch(m)
    counts = {}
    for r in (1.0, 0.5):
        model, params = program(dict(m, residual_multiplier=r, embedding_multiplier=r, logits_scaling=r))
        with torch.no_grad(), Count() as c:
            model.loss_fn(params, batch)
        counts[r] = c.n
    # two branches a layer, the embedding and the logits
    assert counts[0.5] - counts[1.0] == 2 * m["n_layers"] + 2


def test_the_gated_norm_takes_its_eps_from_the_config():
    cfg = get_config(ARCH)
    assert _mamba_spec(cfg).norm_eps == 1e-5
    assert _mamba_spec(get_config("mamba2-1.3b")).norm_eps == 1e-6 == SSM.MambaSpec(8).norm_eps
    g = torch.Generator().manual_seed(0)
    y, z, scale = torch.randn(2, 5, 16, generator=g) * 1e-3, torch.randn(2, 5, 16, generator=g), torch.ones(16)
    a, b = SSM._gated_norm(scale, y, z, 1e-6), SSM._gated_norm(scale, y, z, 1e-5)
    want = y * torch.nn.functional.silu(z)
    for got, eps in ((a, 1e-6), (b, 1e-5)):
        assert torch.allclose(got, want * torch.rsqrt(want.pow(2).mean(-1, keepdim=True) + eps), rtol=1e-5)


def test_nope_attention_does_not_see_positions():
    g = torch.Generator().manual_seed(1)
    spec = L.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, rope=False, scale=0.3)
    p = L.init_attention(g, spec, torch.float32)
    x = torch.randn(2, 12, 32, generator=g)
    pos = torch.arange(12).expand(2, 12)
    with torch.no_grad():
        a, b = L.mha(p, spec, x, pos), L.mha(p, spec, x, pos + 7)
        roped = dataclasses.replace(spec, rope=True)
        c, d = L.mha(p, roped, x, pos), L.mha(p, roped, x, pos + 7)
    assert torch.equal(a, b) and not torch.allclose(c, d)


def test_the_registry_entry_has_the_published_sizes():
    cfg = get_config(ARCH)
    kinds = [cfg.block_pattern[i % cfg.pattern_len] for i in range(cfg.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "moe"] == [5, 15, 25, 35]
    assert kinds == ["moe" if t == "attention" else "mamba2_moe" for t in CONFIG["layer_types"]]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.vocab) == \
        (40, 4096, 32, 8, 128, 100352)
    assert (cfg.n_experts, cfg.top_k, cfg.expert_d_ff, cfg.shared_d_ff) == (72, 10, 768, 1536)
    assert cfg.held_experts == range(72)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand, cfg.ssm_conv, cfg.ssm_chunk) == (128, 64, 2, 4, 256)
    assert _mamba_spec(cfg).n_heads == 128 and cfg.tie_embeddings and cfg.position_embedding == "nope"
    assert (cfg.attn_scale, cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling) == \
        (0.0078125, 12.0, 0.22, 16.0)
    assert cfg.norm_eps == cfg.ssm_norm_eps == 1e-5 and cfg.moe_route == "dropless"


# ---------------------------------------------------------- the route ----
def _moe(n_experts=8, top_k=3, first=0, held=0, seed=3):
    s = MOE.MoESpec(d_model=16, n_experts=n_experts, top_k=top_k, expert_d_ff=12, n_shared_experts=1,
                    shared_d_ff=20, route="dropless", first_expert=first, n_held=held)
    return s, MOE.init_moe(torch.Generator().manual_seed(seed), s, torch.float32)


def _share(p: MOE.MoE, s: MOE.MoESpec, first: int, held: int):
    """The layer ``p`` holding experts first .. first + held - 1 only."""
    s2 = dataclasses.replace(s, first_expert=first, n_held=held)
    ex = p.experts
    lo, hi = first - s.first_expert, first - s.first_expert + held
    return s2, MOE.MoE(p.router, MOE.Experts(ex.gate[lo:hi].detach(), ex.up[lo:hi].detach(), ex.down[lo:hi].detach()),
                       p.shared)


def loop_moe(p: MOE.MoE, s: MOE.MoESpec, x: torch.Tensor) -> torch.Tensor:
    """The held experts' part, a token and a choice at a time, plus the shared expert."""
    x2 = x.reshape(-1, x.shape[-1])
    ids, w, _ = MOE._routing(p, s, x2)
    rows = []
    for t in range(x2.shape[0]):
        acc = torch.zeros_like(x2[t])
        for j in range(s.top_k):
            e = int(ids[t, j]) - s.first_expert
            if 0 <= e < s.held:
                h = torch.nn.functional.silu(x2[t] @ p.experts.gate[e]) * (x2[t] @ p.experts.up[e])
                acc = acc + w[t, j] * (h @ p.experts.down[e])
        rows.append(acc)
    return torch.stack(rows).view(x.shape) + L.ffn(p.shared, x)


def _skewed(p: MOE.MoE, x: torch.Tensor, top: list[int]):
    """Make every token's top choices ``top`` (in that order)."""
    with torch.no_grad():
        p.router.w.zero_()
        for rank, e in enumerate(top):
            p.router.w[0, e] = 10.0 * (len(top) - rank)
        x[..., 0] = 1.0 + x[..., 0].abs() * 0.01


@pytest.mark.parametrize("skew", ["none", "one_held_expert", "held_elsewhere"])
def test_dropless_route_equals_a_per_token_loop(skew):
    s, p = _moe(first=2, held=2)
    x = torch.randn(2, 24, 16, generator=torch.Generator().manual_seed(5))
    if skew == "one_held_expert":  # every token on expert 2; expert 3 gets none
        _skewed(p, x, [2, 0, 1])
    elif skew == "held_elsewhere":
        _skewed(p, x, [0, 1, 4])
    x.requires_grad_(True)
    before = len(obs.tallies("moe.rows"))
    y, aux = MOE.moe_ffn(p, s, x)
    rows, largest = obs.tallies("moe.rows")[before][1]
    ref = loop_moe(p, s, x)
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-6)
    ids, _, _ = MOE._routing(p, s, x.detach().reshape(-1, 16))
    on = (ids >= 2) & (ids < 4)
    assert rows == int(on.sum()) and largest == max(int((ids == 2).sum()), int((ids == 3).sum()))
    if skew == "one_held_expert":
        assert rows == 48 and largest == 48  # no token dropped, far past any capacity
    if skew == "held_elsewhere":
        assert rows == 0 and torch.allclose(y, L.ffn(p.shared, x), rtol=0, atol=0)
    leaves = [x, p.experts.gate, p.experts.up, p.experts.down, p.router.w]
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
    got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    want = torch.autograd.grad(ref, leaves, dy, allow_unused=True, materialize_grads=True)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-6)


def test_the_four_shares_add_up_to_the_uncut_layer():
    """Each of 4 ranks holds a quarter of the experts and routes over all of
    them; their routed parts plus the shared expert, counted once, are the
    layer with every expert held."""
    s, p = _moe()
    x = torch.randn(2, 24, 16, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        whole, aux = MOE.moe_ffn(p, s, x)
        shared = L.ffn(p.shared, x)
        parts = []
        for first in range(0, 8, 2):
            s2, p2 = _share(p, s, first, 2)
            y, aux2 = MOE.moe_ffn(p2, s2, x)
            assert torch.equal(aux2, aux)
            parts.append(y - shared)
    assert torch.allclose(sum(parts) + shared, whole, rtol=1e-5, atol=1e-6)


def test_grouped_products_equal_a_loop_and_leave_rows_past_the_groups_at_zero():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(30, 16, generator=g)
    gate, up = torch.randn(3, 16, 12, generator=g), torch.randn(3, 16, 12, generator=g)
    down = torch.randn(3, 12, 16, generator=g)
    offs = torch.tensor([7, 7, 19], dtype=torch.int32)  # an empty group; rows 19.. routed elsewhere
    leaves = [t.requires_grad_(True) for t in (x, gate, up, down)]
    y = MOE.GroupedSwiGLU.apply(*leaves, offs)
    bounds = [(0, 0, 7), (1, 7, 7), (2, 7, 19)]
    want = torch.zeros_like(y)
    for e, lo, hi in bounds:
        want[lo:hi] = (torch.nn.functional.silu(x[lo:hi] @ gate[e]) * (x[lo:hi] @ up[e])) @ down[e]
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5) and torch.equal(y[19:], torch.zeros_like(y[19:]))
    dy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, leaves, dy)
    ref = torch.autograd.grad(want, leaves, dy)
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[0][19:], torch.zeros_like(got[0][19:])) and torch.equal(got[1][1], torch.zeros(16, 12))


def test_the_step_pauses_the_collector_and_collects_each_pass_young():
    """The train step runs with Python's cyclic collector paused and gives
    it back as it found it (running or not, also where the step raises);
    inside it the only collections are one young pass after each
    microbatch's forward, and no garbage cycle holding a tensor outlives
    the step, the model's first included (a lazy import's cycles hold its
    frames)."""
    import gc

    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.loop import build_train_step

    m = tiny_model()
    model, params = program(m)
    opt = AdamWConfig()
    state = {"params": params, "opt": adamw_init(dict(params.named_parameters()), opt)}
    batch = make_batch(m, SEED, 0, "cpu")
    seen, inside, passes = [], [False], []
    loss_fn = model.loss_fn

    def watched(p, b):
        if not b:
            raise ValueError("no batch")
        inside[0] = True
        seen.append(gc.isenabled())
        return loss_fn(p, b)

    def note(phase, info):
        if phase == "start" and inside[0]:
            passes.append(info["generation"])

    step = build_train_step(dataclasses.replace(model, loss_fn=watched), opt, 2)
    running = gc.isenabled()
    gc.callbacks.append(note)
    try:
        gc.collect()
        for on in (True, False):
            (gc.enable if on else gc.disable)()
            state, _ = step(state, batch)
            inside[0] = False
            assert gc.isenabled() is on
            gc.disable()
            gc.set_debug(gc.DEBUG_SAVEALL)
            gc.collect()  # what the step left to the collector
            gc.set_debug(0)
            assert not [o for o in gc.garbage if isinstance(o, torch.Tensor)]
            gc.garbage.clear()
        assert passes == [0] * 4
        gc.enable()
        with pytest.raises(ValueError):
            step(state, {})
        assert gc.isenabled()
    finally:
        gc.callbacks.remove(note)
        gc.set_debug(0)
        gc.garbage.clear()
        (gc.enable if running else gc.disable)()
    assert seen == [False] * 4
