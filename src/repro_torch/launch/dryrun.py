"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, placed.

A port of the JAX package's ``launch/dryrun.py``. Where the reference
lowers and compiles the step for 512 host devices, this runs it once,
eagerly, as rank 0 of a process group on the ``fake`` backend (collectives
return at once) with every tensor a DTensor whose local shard is on the
``meta`` device: shapes, placements and the collectives DTensor issues are
real; no number is computed and nothing is allocated. For each cell:

  1. build the FULL model config and its parameters (or train state) on
     ``meta``, placed by the rules tables (``launch.specs``),
  2. run the step (train: ``build_train_step``, i.e. loss, grads and AdamW;
     prefill; decode over ``cache_specs``) under the rules,
  3. count per-device FLOPs (``LocalFlopCounter``), bytes read and written
     by the local ops, collective bytes (``CollectiveCounter``) and memory
     (``MemTracker``), and
  4. write results/dryrun/<arch>__<shape>__<mesh>.json.

The record keeps the reference's keys, but its ``hlo_flops``,
``hlo_bytes``, ``temp_bytes`` and ``peak_bytes`` are the eager pass's
counts: no op is fused, so every intermediate is written and read once and
held until its last use. ``tests/test_torch_dryrun.py`` holds each of them
within a factor of 4 of XLA's own (``temp_size_in_bytes``, and the
unrolled build's ``bytes accessed`` and ``flops``) on reduced cells; the
argument bytes are equal to XLA's.

The reference extrapolates its costs from 1- and 2-group unrolled builds
because XLA counts a loop body once; the eager pass counts every layer, so
every cell runs its full config. The dry run is a host pass by design, the
one entry point that does not run on the card. The process group must be
the process's first one: the launchers' ``--dryrun`` start this module in
a subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import pathlib
import threading
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import map_with_path, place_module, placements, use_sharding_rules
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import build_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"
META = torch.device("meta")


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def start_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``world_size`` process group on the
    ``fake`` backend (no peers, collectives return at once)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} is up; the cell needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    # DTensor warns at every multi-axis reduction of a fake step.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def placed(shape: tuple[int, ...], dtype: torch.dtype, pl, mesh) -> DTensor:
    """A ``meta`` DTensor of global ``shape`` at placements ``pl`` on ``mesh``."""
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = torch.empty(local, dtype=dtype, device=META)
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device=META).stride())


def _tensors(tree: Any) -> list[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and modules (their
    parameters and buffers)."""
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *(b for b in tree.buffers() if b is not None)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``, each tensor
    once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


class _Propagating(threading.local):
    active = False


_PROPAGATING = _Propagating()


@contextlib.contextmanager
def _marking_propagation():
    """Mark the tensors DTensor makes to propagate shardings (global-shaped
    stand-ins of each op's inputs), so that ``_OpBytes`` and ``_MemTracker``
    count only the work on the local shards."""
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        prev, _PROPAGATING.active = _PROPAGATING.active, True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.active = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class _MemTracker(MemTracker):
    """``MemTracker`` of the local shards only (see ``_marking_propagation``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _PROPAGATING.active:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class _OpBytes(SP.CollectiveCounter):
    """Bytes each local op reads and writes (its tensor inputs and outputs;
    views, and ops that read no tensor, left out): the counterpart of XLA's
    per-device ``bytes accessed``."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or _PROPAGATING.active or func.is_view or func.namespace != "aten":
            return out
        ins = [a for a in (*args, *(kwargs or {}).values()) if isinstance(a, torch.Tensor)]
        if ins:
            self.op_bytes += sum(SP._out_bytes(a) for a in ins) + SP._out_bytes(out)
        return out


def step_pass(cfg: ModelConfig, shape: ShapeSpec, mesh, rules, opt_cfg: AdamWConfig) -> dict:
    """Run one placed step of ``cfg`` at ``shape`` on ``mesh`` (the
    counterpart of the reference's ``_lower_compile``). Returns the per-device
    costs and memory and ``n_params``."""
    model = build_model(cfg, device=META)
    params = model.init(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in _tensors(params))
    place_module(params, mesh, rules, lambda t, pl: placed(tuple(t.shape), t.dtype, pl, mesh))
    in_specs = model.input_specs(shape)
    in_sh = SP.batch_shardings(mesh, rules, in_specs)
    batch = {k: placed(tuple(s.shape), s.dtype, in_sh[k].placements, mesh) for k, s in in_specs.items()}
    if shape.kind == "train":
        named = dict(params.named_parameters())
        state = {"params": params, "opt": adamw_init(named, opt_cfg)}
        args: Any = (state, batch)
        fn = build_train_step(model, opt_cfg)
    elif shape.kind == "prefill":
        args = (params, batch)
        fn = model.prefill
    else:
        cache_specs = model.cache_specs(shape)
        caches = map_with_path(
            lambda k, s: placed(tuple(s.shape), s.dtype, placements(SP.cache_spec(k, tuple(s.shape), rules), mesh),
                                mesh),
            cache_specs,
        )
        args = (params, caches, batch["token"], batch["pos"])

        last = (shape.seq_len // 2 if cfg.enc_dec else shape.seq_len) - 1

        def fn(params, caches, token, _pos):  # the last slot: the whole cache is read
            return model.decode_step(params, caches, token, last)

    arg_bytes = _local_bytes(args)
    mem = _MemTracker()
    mem.track_external(*_tensors(args))
    flops, ops = SP.LocalFlopCounter(), _OpBytes()
    with _marking_propagation(), use_sharding_rules(rules), mem, flops, ops:
        out = fn(*args)
    peak = mem.get_tracker_snapshot("peak")
    peak_bytes = max((d.get("Total", 0) for d in peak.values()), default=0)
    in_ids = {id(t) for t in _tensors(args)}
    return {
        "n_params": n_params,
        "flops": float(flops.get_total_flops()),
        "bytes": float(ops.op_bytes),
        "coll": {k: float(v) for k, v in ops.bytes.items()},
        "coll_counts": dict(ops.counts),
        "argument_bytes": arg_bytes,
        "output_bytes": _local_bytes([t for t in _tensors(out) if id(t) not in in_ids]),
        "peak_bytes": max(peak_bytes, arg_bytes),
    }


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True) -> dict:
    """One placed step of one cell at its full config; the reference's
    record keys (``tag`` is always "": the port's cells are the registry's
    configs, unaltered)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
                "status": "skipped", "reason": why}

    start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = SP.rules_for(mesh, shape)
    t0 = time.time()
    tot = step_pass(cfg, shape, mesh, rules, AdamWConfig())
    compile_s = time.time() - t0

    n_params = tot["n_params"]
    coll = tot["coll"]
    n_chips = mesh.size()
    n_active = SP.active_params(cfg, n_params)
    flops_dev = tot["flops"]
    bytes_dev = tot["bytes"]
    coll_dev = float(sum(coll.values()))
    t_compute = flops_dev / SP.PEAK_FLOPS
    t_memory = bytes_dev / SP.HBM_BW
    t_coll = coll_dev / SP.LINK_BW
    mflops = SP.model_flops(cfg, shape, n_params, n_active)

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_tag(multi_pod),
        "tag": "",
        "status": "ok",
        "compile_s": round(compile_s, 1),
        "n_chips": n_chips,
        "n_params": n_params,
        "n_active_params": n_active,
        "per_device": {
            "hlo_flops": flops_dev,
            "hlo_bytes": bytes_dev,
            "collective_bytes": coll_dev,
            "collectives": coll,
        },
        "memory": {
            "argument_bytes": tot["argument_bytes"],
            "output_bytes": tot["output_bytes"],
            "temp_bytes": tot["peak_bytes"] - tot["argument_bytes"],
            "peak_bytes": tot["peak_bytes"],
        },
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "bottleneck": max(
                [("compute", t_compute), ("memory", t_memory), ("collective", t_coll)],
                key=lambda kv: kv[1],
            )[0],
            "model_flops_total": mflops,
            "useful_flops_ratio": (mflops / (flops_dev * n_chips)) if flops_dev else 0.0,
            "roofline_fraction": (
                (mflops / SP.PEAK_FLOPS / n_chips)
                / max(t_compute, t_memory, t_coll)
                if max(t_compute, t_memory, t_coll) > 0
                else 0.0
            ),
        },
    }
    if verbose:
        r = rec["roofline"]
        print(
            f"[{rec['mesh']}] {arch:26s} {shape_name:12s} ok "
            f"compile={compile_s:6.1f}s compute={r['t_compute_s']*1e3:8.2f}ms "
            f"mem={r['t_memory_s']*1e3:8.2f}ms coll={r['t_collective_s']*1e3:8.2f}ms "
            f"bound={r['bottleneck']:10s} useful={r['useful_flops_ratio']:.2f} "
            f"roofline={r['roofline_fraction']:.3f} peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB",
            flush=True,
        )
    return rec


def save_record(rec: dict) -> pathlib.Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    f = RESULTS / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    f.write_text(json.dumps(rec, indent=2))
    return f


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    n_ok = n_skip = n_fail = 0
    for arch, shape in cells:
        out = RESULTS / f"{arch}__{shape}__{_mesh_tag(args.multi_pod)}.json"
        if out.exists() and not args.force:
            rec = json.loads(out.read_text())
            print(f"[cached] {arch} {shape} -> {rec['status']}", flush=True)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            continue
        try:
            rec = dryrun_cell(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:
            traceback.print_exc()
            rec = {
                "arch": arch, "shape": shape, "mesh": _mesh_tag(args.multi_pod),
                "status": "fail", "error": f"{type(e).__name__}: {e}"[:2000],
            }
        save_record(rec)
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_fail += rec["status"] == "fail"
    print(f"dry-run done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
