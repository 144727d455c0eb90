"""The port's dry run and its mesh path held against the reference.

* The reference's ``_lower_compile`` on a (2, 4) ``Auto`` mesh of 8 host
  devices beside the port's ``step_pass`` on a (2, 4) mesh of a ``fake``
  process group, for reduced Qwen2.5-32B at train, prefill and decode (8 x
  128 tokens, and 8 x 1024 with 6 heads, which the model axis does not
  divide, so that attention is replicated over it as at full size): the
  per-device argument bytes are equal (the specs and the train state are
  the reference's); the eager pass's temp bytes, bytes accessed and FLOPs
  stand within a factor of 4 of XLA's; collectives are printed beside
  XLA's and not compared.
* One production cell (``dryrun_cell``) returns ``ok`` with the
  reference's record keys, and the launchers' ``--dryrun`` print its lines.
* The mesh path computes the model's function: a 4-rank gloo run on a
  (2, 2) mesh with DTensor parameters and ``shard()`` active gives reduced
  Qwen2.5-32B's float32 prefill, and reduced Qwen1.5-MoE's loss and
  gradients, within 2e-4 of the unsharded ones; on a world-1
  (1, 1) mesh the prefill is bitwise equal; the checkpointer takes
  DTensor leaves whole.

Every process group here is in a subprocess or torn down by its test.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tcore
from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


def _run(args: list[str], timeout: int = 600) -> str:
    out = subprocess.run([sys.executable, *args], env=ENV, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


_KINDS = ("train", "prefill", "decode")

# The reference's record takes its memory from the scanned build and its
# costs from unrolled builds (``_cost_variant``: XLA counts a loop body
# once); at two layers the unrolled build is what it extrapolates to.
_JAX_CELLS = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as D, specs as SP
    from repro.optim import AdamWConfig
    seq, heads = int(sys.argv[1]), int(sys.argv[2])
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), n_heads=heads)
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, seq, 8, kind)
        rules = SP.rules_for(mesh, shape)
        c, n = D._lower_compile(cfg, shape, mesh, rules, AdamWConfig())
        u, _ = D._lower_compile(dataclasses.replace(cfg, unroll_layers=True), shape, mesh, rules, AdamWConfig())
        mem, cost = c.memory_analysis(), u.cost_analysis()
        out[kind] = {"n_params": n, "argument_bytes": mem.argument_size_in_bytes,
                     "temp_bytes": mem.temp_size_in_bytes, "bytes": cost["bytes accessed"],
                     "flops": cost["flops"], "coll": SP.collective_bytes(u.as_text())}
    json.dump(out, sys.stdout)
""")

_PORT_CELLS = textwrap.dedent("""
    import dataclasses, json, sys
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D, specs as SP
    from repro_torch.optim import AdamWConfig
    seq, heads = int(sys.argv[1]), int(sys.argv[2])
    D.start_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), n_heads=heads)
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, seq, 8, kind)
        out[kind] = D.step_pass(cfg, shape, mesh, SP.rules_for(mesh, shape), AdamWConfig())
        out[kind]["temp_bytes"] = out[kind]["peak_bytes"] - out[kind]["argument_bytes"]
    json.dump(out, sys.stdout)
""")

# How far the eager counts may stand from XLA's, either way. Measured on
# these cells: temp bytes 0.27-2.7 x (no fusion keeps every intermediate;
# XLA's decode copies the caches it updates, the port writes them in
# place), bytes accessed 0.8-2.2 x, FLOPs 0.44-1.7 x.
_EAGER_FACTOR = 4.0


def _reduced_cells(seq: int, heads: int) -> tuple[dict, dict]:
    """The reference's and the port's costs of the three reduced cells,
    each side in its own process, the two run side by side."""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(seq), str(heads)], env=ENV, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in (_JAX_CELLS, _PORT_CELLS)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        outs.append(json.loads(out))
    return outs[0], outs[1]


def _hold_to_reference(ref: dict, port: dict):
    for kind in _KINDS:
        r, p = ref[kind], port[kind]
        print(f"{kind}: XLA flops {r['flops']:.4g} collectives {r['coll']}; "
              f"port flops {p['flops']:.4g} collectives {p['coll']}")
        assert p["n_params"] == r["n_params"]
        assert p["argument_bytes"] == r["argument_bytes"], kind
        for key in ("temp_bytes", "bytes", "flops"):
            ratio = p[key] / r[key]
            assert 1 / _EAGER_FACTOR <= ratio <= _EAGER_FACTOR, (kind, key, ratio)


def test_reduced_cells_argument_bytes_equal_reference():
    pytest.importorskip("jax")
    _hold_to_reference(*_reduced_cells(128, 4))


def test_heads_replicated_cells_stand_near_reference():
    """Attention replicated over the model axis, as Qwen2.5-32B's 40 heads
    are over 16 at full size, and the (S, S) scores large beside the rest:
    the costs that dominate the production cells."""
    pytest.importorskip("jax")
    _hold_to_reference(*_reduced_cells(1024, 6))


# The keys of a record of ``repro.launch.dryrun.dryrun_cell`` (its ``rec``).
_REFERENCE_RECORD = {
    "arch": None, "shape": None, "mesh": None, "tag": None, "status": None, "compile_s": None,
    "n_chips": None, "n_params": None, "n_active_params": None,
    "per_device": {"hlo_flops", "hlo_bytes", "collective_bytes", "collectives"},
    "memory": {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"},
    "roofline": {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "model_flops_total",
                 "useful_flops_ratio", "roofline_fraction"},
}


def test_production_cell_is_ok_with_the_reference_record_keys():
    code = ("import json, sys; from repro_torch.launch import dryrun as D; "
            "json.dump(D.dryrun_cell('qwen2.5-32b', 'decode_32k', verbose=False), sys.stdout)")
    rec = json.loads(_run(["-c", code]))
    assert set(rec) == set(_REFERENCE_RECORD)
    for k, sub in _REFERENCE_RECORD.items():
        if sub is not None:
            assert set(rec[k]) == sub, k
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16" and rec["n_chips"] == 256
    assert rec["n_params"] == 32_763_876_352
    # Qwen2.5-32B serving weights are TP-only (model axis of 16): bf16 weights,
    # the caches' (batch 128 / 16, seq 32768 / 16) shards, tokens and pos.
    assert rec["memory"]["argument_bytes"] == 8_391_690_276
    assert rec["per_device"]["hlo_flops"] > 0


# One shape each: the cases may run at once, and each reads back its own record.
@pytest.mark.parametrize("launcher, shape", [("train", "prefill_32k"), ("serve", "decode_32k")])
def test_launchers_dryrun_print_the_cell_lines(launcher, shape):
    out = _run(["-m", f"repro_torch.launch.{launcher}", "--dryrun", "--arch", "qwen2.5-32b", "--shape", shape])
    lines = out.strip().splitlines()
    assert lines[-2].startswith(f"[pod16x16] qwen2.5-32b                {shape:12s} ok compile=")
    assert lines[-1] == "dry-run done: ok=1 skipped=0 failed=0"
    rec = json.loads((ROOT / "results" / "dryrun" / f"qwen2.5-32b__{shape}__pod16x16.json").read_text())
    assert rec["status"] == "ok"


# ---------------------------------------------------------- the mesh path --
def _cfg(attn_impl: str, arch: str = "qwen2.5-32b"):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), param_dtype=torch.float32, attn_impl=attn_impl)


def _tokens(seed: int = 0, seq: int = 128) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 512, (8, seq)).astype(np.int32))


def _batch() -> dict:
    return {"tokens": _tokens(2, 32), "labels": _tokens(3, 32)}


def _place(params, mesh, shape, how: str):
    """Wrap each parameter as a DTensor at ``rules_for(mesh, shape)``'s
    placements: ``from_local`` of the whole tensor (world 1, no copy) or
    ``distribute_tensor`` (a scatter from rank 0)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding import place_module
    from repro_torch.launch import specs as SP

    rules = SP.rules_for(mesh, shape)
    wrap = (lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)) if how == "local" \
        else (lambda t, pl: distribute_tensor(t, mesh, pl))
    place_module(params, mesh, rules, wrap)
    return rules


# The (impl, arch) pairs whose loss gradients the 4-rank run holds: Qwen1.5-MoE's
# blocks hold the dense decoder's attention and FFN (its shared experts) and
# the routed experts, which run on each rank's token groups.
_GRAD_CASES = (("dense", "qwen2-moe-a2.7b"),)


def _mesh_run(rank: int, world: int, store_path: str, out_path: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import placements, use_sharding_rules
    from repro_torch.launch import specs as SP
    from repro_torch.models import build_model

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for impl in ("dense", "chunked"):
            model = build_model(_cfg(impl), device="cpu")
            params = model.init(0)
            rules = _place(params, mesh, SHAPES["prefill_32k"], "distribute")
            spec = SP.batch_shardings(mesh, rules, {"tokens": torch.zeros(8, 128)})["tokens"].spec
            tokens = distribute_tensor(_tokens(), mesh, placements(spec, mesh))
            with use_sharding_rules(rules):
                logits, caches = model.prefill(params, {"tokens": tokens})
            res[f"prefill {impl}"] = logits.full_tensor().tolist()
        for impl, arch in _GRAD_CASES:
            model = build_model(_cfg(impl, arch), device="cpu")
            params = model.init(0)
            rules = _place(params, mesh, SHAPES["train_4k"], "distribute")
            specs = SP.batch_shardings(mesh, rules, {k: v for k, v in _batch().items()})
            batch = {k: distribute_tensor(v, mesh, placements(specs[k].spec, mesh)) for k, v in _batch().items()}
            named = dict(params.named_parameters())
            with use_sharding_rules(rules):
                loss, _ = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(named.values()))
            res[f"loss {arch}"] = float(loss.full_tensor())
            res[f"grads {arch}"] = {n: g.full_tensor().tolist() for n, g in zip(named, grads)}
        if rank == 0:
            Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def test_four_rank_mesh_prefill_and_grads_are_the_unsharded_ones(tmp_path):
    """Reduced float32 models on a (2, 2) mesh of 4 gloo ranks: the
    prefill's logits (dense and chunked attention), and the loss and every
    parameter's gradient of the MoE model, within 2e-4 of the unsharded
    ones."""
    import torch.multiprocessing as mp

    from repro_torch.models import build_model

    out = tmp_path / "out.json"
    mp.spawn(_mesh_run, args=(4, str(tmp_path / "store"), str(out)), nprocs=4, join=True)
    got = json.loads(out.read_text())
    for impl in ("dense", "chunked"):
        model = build_model(_cfg(impl), device="cpu")
        want, _ = model.prefill(model.init(0), {"tokens": _tokens()})
        torch.testing.assert_close(torch.tensor(got[f"prefill {impl}"]), want, rtol=2e-4, atol=2e-4)
    for impl, arch in _GRAD_CASES:
        model = build_model(_cfg(impl, arch), device="cpu")
        params = model.init(0)
        named = dict(params.named_parameters())
        loss, _ = model.loss_fn(params, _batch())
        grads = torch.autograd.grad(loss, list(named.values()))
        assert abs(got[f"loss {arch}"] - loss.item()) <= 2e-4 * (1 + abs(loss.item()))
        assert sorted(got[f"grads {arch}"]) == sorted(named)
        for n, g in zip(named, grads):
            torch.testing.assert_close(torch.tensor(got[f"grads {arch}"][n]), g, rtol=2e-4, atol=2e-4, msg=n)


@pytest.fixture
def world_one():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_world_one_mesh_prefill_is_bitwise_the_unsharded_prefill(world_one, impl):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import placements, use_sharding_rules
    from repro_torch.launch import specs as SP
    from repro_torch.models import build_model

    model = build_model(_cfg(impl), device="cpu")
    want, want_caches = model.prefill(model.init(0), {"tokens": _tokens(1)})
    params = model.init(0)
    rules = _place(params, world_one, SHAPES["prefill_32k"], "local")
    spec = SP.batch_shardings(world_one, rules, {"tokens": torch.zeros(8, 128)})["tokens"].spec
    tokens = DTensor.from_local(_tokens(1), world_one, placements(spec, world_one))
    with use_sharding_rules(rules):
        got, caches = model.prefill(params, {"tokens": tokens})
    assert isinstance(got, DTensor)
    assert torch.equal(got.to_local(), want)
    assert torch.equal(caches[0][0]["k"].to_local(), want_caches[0][0]["k"])


def test_checkpointer_takes_dtensor_leaves_whole(world_one):
    """A tree saved plainly, then again with its leaves as DTensors on the
    mesh: every leaf ref-only, 0 bytes sent, the same manifest, one launch
    pair a save."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)),
            "b": torch.from_numpy(rng.integers(0, 2**16, (300,), dtype=np.uint16).view(np.int16)).view(torch.bfloat16)}
    cluster = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    ck = DedupCheckpointer(cluster, CheckpointConfig(fp_chunk_bytes=4096), device="cpu")
    m1 = ck.save("plain", tree)
    dtree = {"w": DTensor.from_local(tree["w"], world_one, [Shard(0), Shard(1)]),
             "b": DTensor.from_local(tree["b"], world_one, [Replicate(), Shard(0)])}
    sent = ck.stats["bytes_sent"]
    m2 = ck.save("mesh", dtree)
    assert [e["ref"] for e in m2["leaves"]] == [True, True]
    assert [e["key"] for e in m2["leaves"]] == [e["key"] for e in m1["leaves"]]
    assert ck.stats["bytes_sent"] == sent and ck.stats["leaves_ref_only"] == 2
    assert (ck.stats["cdc_launches"], ck.stats["fp_launches"]) == (2, 2)
    back = ck.restore("mesh", like=tree)
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["b"].view(torch.int16), tree["b"].view(torch.int16))
