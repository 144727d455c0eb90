"""Training entrypoint on the port: real steps on the arch's reduced config
with dedup checkpointing against the in-process shared-nothing cluster.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b --steps 50 \
      --ckpt-every 10 [--resume step-10]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-110b --dryrun

The JAX package's ``repro.launch.train``, with the same flags and lines:
single-host steps on CUDA unless ``--device`` names another device (random
weights from seed 0), or with ``--dryrun`` the full config's step placed
on the production mesh at ``--shape`` (``repro_torch.launch.dryrun``, a
host pass).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint name to resume from")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--nodes", type=int, default=4, help="dedup storage nodes")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="train_4k")
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

    from repro_torch.checkpoint import DedupCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.convert import train_state_from_tree, train_state_to_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.train.loop import init_train_state

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    cluster = DedupCluster.create(args.nodes, replicas=2,
                                  chunking=ChunkingSpec("fixed", 256 * 1024))
    ck = DedupCheckpointer(cluster, device=model.device)
    opt = AdamWConfig(total_steps=args.steps, compress_grads=args.compress_grads)
    tcfg = TrainConfig(steps=args.steps, accum=args.accum,
                       checkpoint_every=args.ckpt_every, opt=opt)

    state = None
    start = 0
    if args.resume:
        template = train_state_to_tree(init_train_state(model, 0, opt), cfg)
        state = train_state_from_tree(ck.restore(args.resume, like=template), cfg, model.device)
        start = int(args.resume.split("-")[-1])
        print(f"resumed from {args.resume} at step {start}")

    state, hist = train_loop(model, data, tcfg, checkpointer=ck, state=state, start_step=start)
    for h in hist:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} ({h['sec']:.2f}s)")
    if args.ckpt_every:
        print("checkpoints:", ck.list_checkpoints())
        print("dedup space savings: %.1f%%" % (100 * cluster.space_savings()))
        print("ckpt stats:", ck.stats)


if __name__ == "__main__":
    main()
