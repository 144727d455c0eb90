"""End-to-end training example: train a LM with deduplicated distributed
checkpointing, kill a storage node mid-run, resume from the dedup store.

Default runs a ~10M-param model for 60 steps (CPU-friendly). The ~100M
configuration from the deliverable spec:

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --dim 640 --layers 10 \
        --vocab 32768 --steps 200 --seq 128 --batch 2

The port of ``examples/train_e2e.py``: it trains on CUDA unless ``--device``
names another device, and its checkpoints hold the JAX package's
train-state tree (``train_state_to_tree``).
"""

from __future__ import annotations

import argparse

from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_tree, train_state_to_tree
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop
from repro_torch.train.loop import init_train_state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = ModelConfig(
        arch_id="e2e-lm", family="dense", n_layers=args.layers, d_model=args.dim,
        n_heads=max(4, args.dim // 64), n_kv_heads=max(2, args.dim // 128),
        d_ff=args.dim * 4, vocab=args.vocab, tie_embeddings=True,
    ).validate()
    model = build_model(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.init(0).parameters())
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"params={n_params/1e6:.1f}M")

    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 256 * 1024))
    ck = DedupCheckpointer(cluster, device=model.device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)

    half = args.steps // 2
    print(f"--- phase 1: steps 0..{half} ---")
    tcfg = TrainConfig(steps=half, checkpoint_every=args.ckpt_every,
                       log_every=max(1, half // 6), opt=opt)
    state, hist = train_loop(model, data, tcfg, checkpointer=ck)
    for h in hist:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f}")

    ckpts = ck.list_checkpoints()
    print(f"checkpoints: {ckpts}; cluster savings {100*cluster.space_savings():.1f}%")

    print("--- simulating storage-node failure + elastic replacement ---")
    cluster.crash_node("oss3")
    cluster.add_node()          # replacement joins; HRW moves ~1/5 of chunks
    cluster.scrub()             # restore replication factor

    last = ckpts[-1]
    template = train_state_to_tree(init_train_state(model, 0, opt), cfg)
    state = train_state_from_tree(ck.restore(last, like=template), cfg, model.device)
    start = int(last.split("-")[-1])
    print(f"restored {last} from the degraded cluster (repair via replicas)")

    print(f"--- phase 2: steps {start}..{args.steps} (resumed) ---")
    tcfg2 = TrainConfig(steps=args.steps, checkpoint_every=args.ckpt_every,
                        log_every=max(1, half // 6), opt=opt)
    state, hist2 = train_loop(model, data, tcfg2, checkpointer=ck,
                              state=state, start_step=start)
    for h in hist2:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f}")

    print(f"final ckpts: {ck.list_checkpoints()}")
    print(f"ckpt stats: {ck.stats}")
    print(f"dedup space savings: {100*cluster.space_savings():.1f}%")
    print("train_e2e OK")


if __name__ == "__main__":
    main()
