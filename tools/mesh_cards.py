#!/usr/bin/env python3
"""The mesh path across four cards: Qwen2.5-32B at full width (2 layers,
float32) prefilled on a (2, 2) ("data", "model") mesh of four ranks, one
card each, against the unsharded prefill on one card.

    python3 tools/mesh_cards.py            # four CUDA cards, NCCL
    python3 tools/mesh_cards.py --cpu      # rehearsal: four gloo ranks on the CPU, reduced config

Each rank builds the same random weights from ``--seed``, places them as
DTensors at ``rules_for(mesh, prefill_32k)``'s placements
(``distribute_tensor``) and prefills 2 x 4,096 tokens placed by
``batch_shardings`` under the rules: the batch splits over "data", the
heads, the FFN and the vocab over "model"; each rank's flash kernel takes
its own heads (``local_map``). Rank 0 then prefills the same tokens on its
card without a mesh. Prints one JSON line: the flash launches of each
rank (one a layer), the largest |mesh - plain| of the logits over their
largest |plain| (float32 with TF32 off; held to 2e-4, the port's float32
tolerance), both prefills' seconds (the second call of each), and the
collectives rank 0 issued (``CollectiveCounter``: bytes and counts by
kind), and each card's name and power limit (``nvidia-smi``). Exits 1 if
a check fails. The process group rides on a
``FileStore`` in a temporary directory: no port is opened.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
REL_LIMIT = 2e-4


def _cfg(cpu: bool):
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-32b")
    cfg = cfg.reduced() if cpu else dataclasses.replace(cfg, n_layers=2)
    return dataclasses.replace(cfg, attn_impl="chunked", param_dtype=torch.float32)


def _timed_twice(fn, sync):
    fn()
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def _rank(rank: int, store: str, seed: int, cpu: bool, out_path: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import place_module, placements, use_sharding_rules
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.launch import specs as SP
    from repro_torch.models import build_model

    device = "cpu" if cpu else "cuda"
    if not cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    dist.init_process_group("gloo" if cpu else "nccl", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))
        cfg = _cfg(cpu)
        model = build_model(cfg, device=device)
        params = model.init(seed)
        rules = SP.rules_for(mesh, SHAPES["prefill_32k"])
        place_module(params, mesh, rules, lambda t, pl: distribute_tensor(t, mesh, pl))
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab, (2, 64 if cpu else 4096), generator=gen, device=device)
        spec = SP.batch_shardings(mesh, rules, {"tokens": tokens})["tokens"].spec
        placed = distribute_tensor(tokens, mesh, placements(spec, mesh))

        def mesh_prefill():
            with use_sharding_rules(rules):
                return model.prefill(params, {"tokens": placed})[0]

        flash_attention_cuda.launches = 0
        counter = SP.CollectiveCounter()
        with counter:
            got = mesh_prefill()
        sync()
        launches = flash_attention_cuda.launches
        got = got.full_tensor()
        _, mesh_s = _timed_twice(mesh_prefill, sync)
        all_launches = [None] * WORLD
        dist.all_gather_object(all_launches, launches)
        if rank == 0:
            plain_params = model.init(seed)
            want, plain_s = _timed_twice(lambda: model.prefill(plain_params, {"tokens": tokens})[0], sync)
            rel = float((got - want).abs().max() / want.abs().max())
            Path(out_path).write_text(json.dumps({
                "model": f"{cfg.arch_id}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype}",
                "mesh": "(2, 2) (data, model)", "device": "cpu" if cpu else torch.cuda.get_device_name(0),
                "tokens": list(tokens.shape), "flash_launches_by_rank": all_launches,
                "logits_rel_max_err": rel, "limit": REL_LIMIT,
                "prefill_s": {"mesh": mesh_s, "plain_one_card": plain_s},
                "rank0_collective_bytes": counter.bytes, "rank0_collective_counts": counter.counts,
            }))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    if not args.cpu:
        if torch.cuda.device_count() < WORLD:
            print(f"mesh_cards: needs {WORLD} CUDA devices, sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build

        _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.json"
        mp.spawn(_rank, args=(str(Path(tmp) / "store"), args.seed, args.cpu, str(out)), nprocs=WORLD, join=True)
        rec = json.loads(out.read_text())
    if not args.cpu:
        import subprocess

        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
    print(json.dumps(rec))
    want = 0 if args.cpu else _cfg(False).n_layers  # the CPU route runs no kernel
    ok = rec["logits_rel_max_err"] <= REL_LIMIT and all(n == want for n in rec["flash_launches_by_rank"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
