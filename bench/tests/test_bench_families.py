"""The model families as files (``bench/families/<family>.py``): the move
out of the shared modules kept the weights, the reference's operations,
the FLOP counts, the program's fields and the never-reduced widths, each
held here against a frozen copy of what the harness had before; a family
that is a new file and nothing else runs a cell; a family with no file is
refused by name."""

import json
import math
import os
import shutil
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import families
from bench import weights as W
from bench.job import program_sizes
from bench.metrics import _arith as A
from bench.reference import models as M
from conftest import load, tiny_cell

if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

CONFIGS = {"decoder": "llava-next-mistral-7b.d8", "mamba2": "mamba2-1.3b.d8"}
SEED = 2**31 + 977


# ------------------------------------------------ frozen copies (before) ----
FROZEN_PROGRAM_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab", "rope_theta",
                         "norm_eps", "n_frontend_tokens", "tie_embeddings", "ssm_state", "ssm_head_dim", "ssm_expand",
                         "ssm_conv", "ssm_chunk")
FROZEN_WIDTHS = {"d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "ssm_state", "ssm_head_dim", "ssm_expand",
                 "ssm_conv", "ssm_chunk", "vocab"}


def frozen_layout(m: dict, family: str) -> list:
    d, g, v = m["d_model"], m["n_layers"], W.padded_vocab(m)
    leaves = [(("embed", "table"), (v, d), "normal", 0.02), (("final_norm", "scale"), (d,), "ones", 0.0)]
    b = ("blocks", 0)
    if family == "decoder":
        h, kv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
        leaves.append((("lm_head", "w"), (d, v), "normal", d ** -0.5))
        leaves += [
            ((*b, "norm1", "scale"), (g, d), "ones", 0.0),
            ((*b, "attn", "wq", "w"), (g, d, h * hd), "normal", d ** -0.5),
            ((*b, "attn", "wk", "w"), (g, d, kv * hd), "normal", d ** -0.5),
            ((*b, "attn", "wv", "w"), (g, d, kv * hd), "normal", d ** -0.5),
            ((*b, "attn", "wo", "w"), (g, h * hd, d), "normal", (h * hd) ** -0.5),
            ((*b, "norm2", "scale"), (g, d), "ones", 0.0),
            ((*b, "ffn", "gate", "w"), (g, d, f), "normal", d ** -0.5),
            ((*b, "ffn", "up", "w"), (g, d, f), "normal", d ** -0.5),
            ((*b, "ffn", "down", "w"), (g, f, d), "normal", f ** -0.5),
        ]
    elif family == "mamba2":
        d_in = m["ssm_expand"] * d
        n, heads, k = m["ssm_state"], d_in // m["ssm_head_dim"], m["ssm_conv"]
        mx = (*b, "mixer")
        leaves += [
            ((*b, "norm1", "scale"), (g, d), "ones", 0.0),
            ((*mx, "in_proj", "w"), (g, d, 2 * d_in + 2 * n + heads), "normal", d ** -0.5),
            ((*mx, "conv_w"), (g, k, d_in + 2 * n), "normal", 0.1),
            ((*mx, "conv_b"), (g, d_in + 2 * n), "zeros", 0.0),
            ((*mx, "a_log"), (g, heads), "a_log", 0.0),
            ((*mx, "dt_bias"), (g, heads), "f32:0", 0.0),
            ((*mx, "d_skip"), (g, heads), "f32:1", 0.0),
            ((*mx, "norm_scale"), (g, d_in), "ones", 0.0),
            ((*mx, "out_proj", "w"), (g, d_in, d), "normal", d_in ** -0.5),
        ]
    else:
        raise ValueError(f"unknown family {family!r}")
    return leaves


def frozen_make_tree(m: dict, family: str, seed: int, device) -> dict:
    dtype = W.DTYPES[m["dtype"]]
    spec = frozen_layout(m, family)
    sizes = [math.prod(shape) for _, shape, kind, _ in spec if kind == "normal"]
    gen = torch.Generator(device=device).manual_seed(W.sub_seed(seed, "weights"))
    flat = torch.empty((sum(sizes),), dtype=dtype, device=device).normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, shape, kind, scale in spec:
        if kind == "normal":
            n = math.prod(shape)
            t = flat[off : off + n].view(shape).mul_(scale)
            off += n
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "a_log":
            t = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device)).expand(shape)
            t = t.contiguous()
        else:
            t = torch.full(shape, float(kind.split(":")[1]), dtype=torch.float32, device=device)
        W._put(tree, path, t)
    tree["blocks"] = tuple(tree["blocks"])
    tree["tail"] = ()
    return tree


def frozen_decoder_layer(p, m, x):
    b, s, _ = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    a = M.rms_norm(x, p["norm1"]["scale"], m["norm_eps"])
    q = M.rotary(M.matmul(a, p["attn"]["wq"]["w"]).view(b, s, h, hd), m["rope_theta"])
    k = M.rotary(M.matmul(a, p["attn"]["wk"]["w"]).view(b, s, kv, hd), m["rope_theta"])
    v = M.matmul(a, p["attn"]["wv"]["w"]).view(b, s, kv, hd)
    x = x + M.matmul(M.causal_attention(q, k, v).reshape(b, s, h * hd), p["attn"]["wo"]["w"])
    a = M.rms_norm(x, p["norm2"]["scale"], m["norm_eps"])
    f = p["ffn"]
    return x + M.matmul(F.silu(M.matmul(a, f["gate"]["w"])) * M.matmul(a, f["up"]["w"]), f["down"]["w"])


def frozen_decoder_loss(params, m, batch):
    x = params["embed"]["table"][batch["tokens"].long()]
    n_front = 0
    if "patch_embeds" in batch:
        n_front = batch["patch_embeds"].shape[1]
        x = torch.cat([batch["patch_embeds"], x], dim=1)
    blocks = params["blocks"][0]
    for g in range(m["n_layers"]):
        x = checkpoint(frozen_decoder_layer, M._layer(blocks, g), m, x, use_reentrant=False)
    x = M.rms_norm(x[:, n_front:], params["final_norm"]["scale"], m["norm_eps"])
    return M.cross_entropy(M.matmul(x, params["lm_head"]["w"]), batch["labels"], m["vocab"])


def frozen_mamba_layer(p, m, x):
    return x + M.mamba_mixer(p["mixer"], M.rms_norm(x, p["norm1"]["scale"], m["norm_eps"]), m)


def frozen_mamba_loss(params, m, batch):
    table = params["embed"]["table"]
    x = table[batch["tokens"].long()]
    blocks = params["blocks"][0]
    for g in range(m["n_layers"]):
        x = checkpoint(frozen_mamba_layer, M._layer(blocks, g), m, x, use_reentrant=False)
    x = M.rms_norm(x, params["final_norm"]["scale"], m["norm_eps"])
    return M.cross_entropy(M.matmul(x, table.t()), batch["labels"], m["vocab"])


FROZEN_LOSSES = {"decoder": frozen_decoder_loss, "mamba2": frozen_mamba_loss}


def frozen_model_flop_per_step(m: dict, family: str) -> float:
    b, s = m["global_batch"], m["seq_len"]
    d, layers, vocab = m["d_model"], m["n_layers"], m["vocab"]
    text = s - m.get("n_frontend_tokens", 0)
    if family == "decoder":
        h, kv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
        per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f
        products = 6 * (per_layer * layers * b * s + d * vocab * b * text)
        attn = 3 * 2 * (2 * hd) * h * A.attention_pairs(s, s, True, 0) * b * layers
        return float(products + attn)
    d_in = m["ssm_expand"] * d
    n, p, q = m["ssm_state"], m["ssm_head_dim"], m["ssm_chunk"]
    heads = d_in // p
    per_layer = d * (2 * d_in + 2 * n + heads) + d_in * d
    products = 6 * (per_layer * layers * b * s + d * vocab * b * s)
    chunks = s // q
    ssd = 2 * (q * q * n + q * q * heads * p + 2 * q * n * heads * p) * chunks * b * layers
    return float(products + 3 * ssd)


FROZEN_TINY = {
    "decoder": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=300,
                    n_frontend_tokens=4, seq_len=32),
    "mamba2": dict(n_layers=2, d_model=32, ssm_state=8, ssm_head_dim=8, ssm_chunk=8, vocab=300, seq_len=32),
}


# ------------------------------------------------------------- the move ----
def _model(fam: str, sizes: str, dtype: str | None = None) -> dict:
    """The configuration's run sizes, its published ones, or its tiny ones."""
    cfg = load("configs", CONFIGS[fam])
    m = dict(cfg["model"])
    if sizes == "published":
        m.update(cfg["published"])
    elif sizes == "tiny":
        m.update(families.family(fam).TINY)
    if dtype:
        m["dtype"] = dtype
    return m


@pytest.mark.parametrize("fam", sorted(CONFIGS))
@pytest.mark.parametrize("sizes", ["run", "published", "tiny"])
def test_the_leaves_flops_and_fields_are_the_ones_before(fam, sizes):
    """The program's fields are the ``ModelConfig`` fields the file sets:
    the same keys and values the fixed tuple gave."""
    from repro_torch.configs import get_config

    m = _model(fam, sizes)
    mod = families.family(fam)
    assert mod.layout(m) == frozen_layout(m, fam)
    assert mod.model_flop_per_step(m) == frozen_model_flop_per_step(m, fam)
    base = get_config(load("configs", CONFIGS[fam])["arch"])
    assert program_sizes(m, base) == {f: m[f] for f in FROZEN_PROGRAM_FIELDS if f in m}
    assert mod.TINY == FROZEN_TINY[fam]


def test_the_never_reduced_widths_are_the_ones_before():
    assert set().union(*(families.family(fam).WIDTHS for fam in CONFIGS)) == FROZEN_WIDTHS


@pytest.mark.parametrize("fam", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_tree_draws_the_same_bits(fam, seed, dtype):
    from bench.reference.train import flat, leaf_names

    m = _model(fam, "tiny", dtype)
    got, want = W.make_tree(m, fam, seed, "cpu"), frozen_make_tree(m, fam, seed, "cpu")
    assert leaf_names(got) == leaf_names(want) and got["tail"] == want["tail"] == ()
    assert len(flat(got)) == len(flat(want)) > 0
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("fam", sorted(CONFIGS))
@pytest.mark.parametrize("product", ["plain", "float8"])
def test_the_reference_loss_and_gradients_are_the_ones_before(fam, product):
    """One microbatch at the tiny sizes in float32: the family file's loss
    and every gradient equal the frozen loss's exactly, with the plain
    products and with the float8 control's (which must reach the family's
    products: its loss differs from the plain one)."""
    from bench.control import float8_matmul
    from bench.reference.train import flat, map_tree

    m = _model(fam, "tiny", "float32")
    batch = W.microbatches(W.make_batch(m, SEED, 0, "cpu"), m["accum"])[0]
    readings = {}
    M.matmul = float8_matmul if product == "float8" else M._plain_matmul
    try:
        for name, fn in (("family", families.family(fam).loss), ("frozen", FROZEN_LOSSES[fam])):
            params = map_tree(lambda t: t.float().requires_grad_(True), W.make_tree(m, fam, SEED, "cpu"))
            loss = fn(params, m, batch)
            readings[name] = (loss.detach(), torch.autograd.grad(loss, flat(params)))
        M.matmul = M._plain_matmul
        params = map_tree(lambda t: t.float(), W.make_tree(m, fam, SEED, "cpu"))
        plain = families.family(fam).loss(params, m, batch).detach()
    finally:
        M.matmul = M._plain_matmul
    (loss, grads), (loss0, grads0) = readings["family"], readings["frozen"]
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0) and all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))
    assert torch.equal(loss, plain) == (product == "plain")


# ----------------------------------------------------- a family is a file ----
def test_a_new_family_is_a_file_and_nothing_else(cpu_threads, tmp_path, monkeypatch):
    """``decoder`` copied under another name into a directory of its own,
    with a configuration that names it: a tiny cell of it runs correct
    (traced, so that ``mfu.train`` counts the copy's FLOPs), and not correct
    with half of each batch left out."""
    from bench.control import half_batch
    from bench.run import run_cell

    bench, cell, config, traffic, limits = tiny_cell("llava-next-7b.train")
    shutil.copy(families.HERE / "decoder.py", tmp_path / "throwaway.py")
    config.update(name="throwaway.d8", family="throwaway")
    (tmp_path / "throwaway.d8.json").write_text(json.dumps(config))
    config = json.loads((tmp_path / "throwaway.d8.json").read_text())
    monkeypatch.setattr(families, "HERE", tmp_path)
    fam = families.family("throwaway")
    assert fam.__file__ == str(tmp_path / "throwaway.py")
    assert all(hasattr(fam, name) for name in families.NAMES)

    new = dict(cell, name="throwaway.train", config="throwaway.d8")
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell["name"] in m.get("workloads", []):
            m["workloads"].append(new["name"])
    res = run_cell(bench, new, config, traffic, limits, SEED, 0.5, True, device="cpu")
    assert res["correct"] is True, res["checks"]
    flop = fam.model_flop_per_step(config["model"])
    assert flop == frozen_model_flop_per_step(config["model"], "decoder") and res["metrics"]["mfu.train"]["value"] > 0
    res = run_cell(bench, new, config, traffic, limits, SEED, 0.5, False, device="cpu", step_fn_wrapper=half_batch)
    assert res["correct"] is False


def test_a_family_with_no_file_is_refused_by_its_file_name():
    """Not a KeyError, and not another family's formula: the loader's error,
    naming the file it looked for, wherever the harness asks (the weights,
    the reference's loss, the ``mfu`` readers' FLOPs)."""
    from bench.check import reference_readings
    from bench.run import reader

    config = load("configs", CONFIGS["mamba2"])
    config["model"].update(families.family("mamba2").TINY)
    config["family"] = "nosuch"
    m = config["model"]
    run = SimpleNamespace(m=m, config=config, untraced=lambda kind: [object()])
    calls = [lambda: families.family("nosuch"), lambda: W.make_tree(m, "nosuch", 0, "cpu"),
             lambda: reference_readings(config, 0, "cpu", 1), lambda: reader("mfu.train")(run),
             lambda: reader("mfu.ckpt")(run)]
    for call in calls:
        with pytest.raises(FileNotFoundError, match=r"nosuch\.py"):
            call()
