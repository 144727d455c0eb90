"""The Granite-4.0-H-Small cell's additions: its family file through the
checks the other families pass (the layout is the program's parameter tree;
a tiny run is correct, and not correct with half of each batch left out;
the float8 control reads above the program), the configuration file against
the catalog's names, and the three readers on synthetic runs."""

import os
from types import SimpleNamespace

import pytest
import torch

from bench.families import family
from bench.job import Record, program_sizes
from bench.run import RunView, reader
from bench.trace import Summary
from conftest import load, tiny_cell

if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

CELL = "granite-4.0-h-small.train"
CONFIG = load("configs", "granite-4.0-h-small.d10")
FAM = family("granitemoehybrid")
SEED = 2**31 + 977
GEMM = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13GemmUniversal"
        "INS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEEE")
SETUP = "void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>(...)"


def _spec_leaves(tree, path=()):
    from repro_torch.models.transformer import TensorSpec

    if isinstance(tree, TensorSpec):
        yield path, tuple(tree.shape)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, (*path, i))


@pytest.mark.parametrize("sizes", ["run", "tiny"])
def test_the_layout_is_the_programs_parameter_tree(sizes):
    """Every leaf the family draws is a leaf of the program's tree (its
    ``param_specs``, no memory taken) with the same shape, and no leaf of
    the program's is left undrawn."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    m = dict(CONFIG["model"], **(FAM.TINY if sizes == "tiny" else {}))
    base = get_config(CONFIG["arch"])
    cfg = dataclasses.replace(base, **program_sizes(m, base), **CONFIG["program"])
    specs = dict(_spec_leaves(build_model(cfg, device="cpu").param_specs()))
    drawn = {path: shape for path, shape, _, _ in FAM.layout(m)}
    assert drawn == specs


def test_the_file_keeps_the_catalogs_names_beside_the_programs():
    """The catalog's keys at the top of the file are the sizes the program
    and the reference run (with ``num_hidden_layers`` and
    ``num_local_experts`` as cut; the latter is the program's experts held,
    ``n_held_experts``, the router staying ``n_experts`` wide)."""
    m, c = CONFIG["model"], CONFIG
    same = {"hidden_size": "d_model", "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
            "intermediate_size": "expert_d_ff", "shared_intermediate_size": "shared_d_ff",
            "num_experts_per_tok": "top_k", "mamba_d_state": "ssm_state", "mamba_d_head": "ssm_head_dim",
            "mamba_expand": "ssm_expand", "mamba_d_conv": "ssm_conv", "mamba_chunk_size": "ssm_chunk",
            "rms_norm_eps": "norm_eps", "attention_multiplier": "attn_scale", "vocab_size": "vocab",
            "embedding_multiplier": "embedding_multiplier", "residual_multiplier": "residual_multiplier",
            "logits_scaling": "logits_scaling", "num_hidden_layers": "n_layers",
            "num_local_experts": "n_held_experts", "layer_types": "layer_types",
            "tie_word_embeddings": "tie_embeddings"}
    for ours, theirs in same.items():
        assert c[ours] == m[theirs], ours
    assert m["ssm_norm_eps"] == c["rms_norm_eps"] and m["head_dim"] * m["n_heads"] == c["hidden_size"]
    assert c["mamba_n_heads"] == m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"] and c["mamba_n_groups"] == 1
    assert c["position_embedding_type"] == "nope" and c["mamba_conv_bias"] and not c["mamba_proj_bias"]
    assert CONFIG["published"]["num_local_experts"] == m["n_experts"] == 72 and m["n_held_experts"] == 18
    assert CONFIG["published"]["num_hidden_layers"] == 40 and m["n_layers"] == 10 == len(m["layer_types"]) // 4


def test_model_flops_by_hand():
    """91.2 TFLOP a step at the run sizes: 6 x applied weights x tokens, the
    routed experts at 10 x 18 / 72 a token, and 3 x SSD's and attention's
    forward FLOPs."""
    m = CONFIG["model"]
    t = 2 * 4096
    mixer = 4096 * (2 * 8192 + 256 + 128) + 8192 * 4096
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    ffn = 4096 * 72 + 2.5 * 3 * 4096 * 768 + 3 * 4096 * 1536
    products = 6 * t * (9 * mixer + attn + 10 * ffn + 4096 * 100352)
    ssd = 2 * (256 * 256 * 128 + 256 * 256 * 128 * 64 + 2 * 256 * 128 * 128 * 64) * 16 * 2 * 9
    pairs = 2 * 256 * 32 * (4096 * 4097 // 2) * 2
    assert FAM.model_flop_per_step(m) == pytest.approx(products + 3 * (ssd + pairs), rel=1e-12)
    assert 90e12 < FAM.model_flop_per_step(m) < 92.5e12


# ------------------------------------------------------------- tiny runs ----
def test_a_tiny_run_is_correct_and_not_with_half_a_batch(cpu_threads):
    from bench.control import half_batch
    from bench.run import run_cell

    bench, cell, config, traffic, limits = tiny_cell(CELL)
    res = run_cell(bench, cell, config, traffic, limits, SEED, 0.5, True, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["mfu.granite"]["value"] > 0
    res = run_cell(bench, cell, config, traffic, limits, SEED, 0.5, False, device="cpu", step_fn_wrapper=half_batch)
    assert res["correct"] is False


def test_the_float8_control_reads_above_the_program(cpu_threads):
    from bench import check
    from bench.control import float8_matmul, program_readings
    from bench.job import FOLLOWED_STEPS
    from bench.reference import models as M

    _, _, config, traffic, _ = tiny_cell(CELL, "bfloat16")
    ref = check.reference_readings(config, SEED, "cpu", FOLLOWED_STEPS)
    prog = check.training_numbers(program_readings(config, traffic, SEED, "cpu"), ref)
    M.matmul = float8_matmul
    try:
        ctrl = check.training_numbers(check.reference_readings(config, SEED, "cpu", FOLLOWED_STEPS), ref)
    finally:
        M.matmul = M._plain_matmul
    print(prog, ctrl)
    assert ctrl["grad_leaf_gap"] > prog["grad_leaf_gap"]


# --------------------------------------------------------------- readers ----
class Log:
    """A program log holding ``moe.rows`` calls at the given host times."""

    def __init__(self, calls):
        self.calls = calls

    def tallies(self, name):
        return self.calls if name == "moe.rows" else []


def _view(kernels, trace=True):
    class Job:
        config, traffic = CONFIG, {}
        records = [Record("step", 10.0 + i, 11.0 + i, {}, {"tokens": 8192}) for i in range(4)]

    summary = Summary(4.0, 3.0, kernels, {}, {"step": 2}, [0.9, 0.9], [1.0, 1.0], []) if trace else None
    return RunView(Job, 10.0, 14.0, 1.0, summary, (11.0, 13.0))


def _bound_s(rows):
    flop = 2 * rows * 4096 * 768
    nbytes = 2 * (18 * 4096 * 768 + rows * (4096 + 768))
    return max(flop / 989e12, nbytes / 3.35e12)


def test_the_roofline_of_kernels_at_exactly_their_bound_is_100():
    """Calls before the window are left out; the launches of the GEMM are
    counted, the argument setup's time is added to theirs."""
    rows = [(5.0, [1.0, 1.0]), (10.5, [10000.0, 700.0]), (12.5, [10480.0, 720.0])]
    mean = (10000 + 10480) / 2
    n = 24
    seconds = n * _bound_s(mean)
    view = _view({GEMM: [n, seconds * 0.97], SETUP: [n, seconds * 0.03]})
    read = reader("moe_expert_roofline")
    assert read(view, Log(rows)) == pytest.approx(100.0)
    view = _view({GEMM: [n, seconds * 2], SETUP: [n, 0.0]})
    assert read(view, Log(rows)) == pytest.approx(50.0)


def test_the_roofline_reads_nothing_without_a_grouped_kernel_or_a_tally():
    read = reader("moe_expert_roofline")
    rows = [(10.5, [10000.0, 700.0])]
    assert read(_view({"flash_fwd_wgmma<128, 128>": [2, 0.01], "sm90_xmma_gemm_bf16bf16": [40, 0.2]}),
                Log(rows)) is None
    assert read(_view({GEMM: [24, 0.01]}), Log([])) is None
    assert read(_view({GEMM: [24, 0.01]}), SimpleNamespace()) is None
    assert read(_view({GEMM: [24, 0.01]}, trace=False), Log(rows)) is None


def test_the_bound_is_the_larger_of_flops_and_bytes():
    m = {"d_model": 4096, "expert_d_ff": 768, "n_held_experts": 18, "n_experts": 72}
    from importlib import util

    from bench.run import BENCH

    spec = util.spec_from_file_location("roof", BENCH / "metrics" / "moe_expert_roofline.py")
    roof = util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    assert roof.launch_bound_s(10240, m) == pytest.approx(2 * 10240 * 4096 * 768 / 989e12)
    assert roof.launch_bound_s(100, m) == pytest.approx(2 * (18 * 4096 * 768 + 100 * 4864) / 3.35e12)
    assert roof.is_grouped(GEMM) and roof.is_grouped(SETUP) and not roof.is_grouped("sm90_xmma_gemm_bf16bf16")


def test_mfu_and_idle_read_as_the_training_cells_readers():
    view = _view({GEMM: [1, 0.1]})
    view.traced = (11.0, 13.0)
    steps = [r for r in view.records if r.t1 <= 11.0 or r.t0 >= 13.0]
    want = 100.0 * FAM.model_flop_per_step(CONFIG["model"]) * len(steps) / sum(r.s for r in steps) / 989e12
    assert reader("mfu.granite")(view) == pytest.approx(want) == reader("mfu.train")(view)
    assert reader("device_idle.granite")(view) == pytest.approx(10.0) == reader("device_idle.train")(view)
