"""Serving entrypoint: requests against a decoder LM with cluster-wide KV
prefix-cache dedup, on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-110b --dryrun --shape decode_32k

The model is the arch's reduced variant (as the JAX package's
``repro.launch.serve``), with random weights from seed 0, on CUDA unless
``--device`` names another device. ``--dryrun`` places the full config's
step on the production mesh at ``--shape`` instead
(``repro_torch.launch.dryrun``, a host pass).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=48)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.dryrun:
        # Re-exec through the dry run: its fake process group must be the
        # first one of its process.
        import os
        import subprocess
        import sys

        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", args.arch, "--shape", args.shape, "--force"]
        raise SystemExit(subprocess.call(cmd, env=os.environ))

    from repro_torch.configs import get_config
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(args.arch).reduced()
    if set(cfg.block_pattern) != {"attn_global"}:
        cfg = dataclasses.replace(cfg, block_pattern=("attn_global",), window=0)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    cluster = DedupCluster.create(args.nodes, chunking=ChunkingSpec("fixed", 64 * 1024))
    srv = BatchedServer(model, params, cluster,
                        ServeConfig(max_len=args.shared_prefix + 64, block_tokens=8))

    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, cfg.vocab, args.shared_prefix)]
    for i in range(args.requests):
        suffix = [int(t) for t in rng.integers(0, cfg.vocab, 8)]
        r = srv.handle(shared + suffix, gen_tokens=args.gen_tokens)
        print(f"req {i:3d}: reused={r['reused_tokens']:4d} computed={r['computed_tokens']:4d}")
    s = srv.kv.stats
    print(f"prefix-cache hit rate: {s.hit_rate:.2%}  tokens reused: {s.tokens_reused}")
    print(f"cluster space savings: {100 * cluster.space_savings():.1f}%")


if __name__ == "__main__":
    main()
