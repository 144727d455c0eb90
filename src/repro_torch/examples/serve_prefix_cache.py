"""Serving with cluster-wide KV prefix-cache dedup: many requests sharing a
system prompt reuse each other's KV blocks — across serving replicas —
because block identity is the chain fingerprint of token content.

    PYTHONPATH=src python -m repro_torch.examples.serve_prefix_cache [--device cpu]

The port of ``examples/serve_prefix_cache.py``: the model runs on CUDA
unless ``--device`` names another device.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.models import build_model
from repro_torch.serving import BatchedServer, ServeConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: cuda)")
args = ap.parse_args()

cfg = get_config("qwen2.5-32b").reduced()
model = build_model(cfg, device=args.device)
params = model.init(0)
cluster = DedupCluster.create(4, chunking=ChunkingSpec("fixed", 64 * 1024))
server = BatchedServer(model, params, cluster, ServeConfig(max_len=128, block_tokens=8))

rng = np.random.default_rng(0)
system_prompt = [int(t) for t in rng.integers(0, cfg.vocab, 48)]  # shared prefix

print("request | reused | computed | (prefix tokens reused from the cluster)")
for i in range(8):
    user_suffix = [int(t) for t in rng.integers(0, cfg.vocab, 8)]
    r = server.handle(system_prompt + user_suffix, gen_tokens=8)
    print(f"  {i:4d}  |  {r['reused_tokens']:4d}  |   {r['computed_tokens']:4d}")

s = server.kv.stats
print(f"\nblock hit rate      : {s.hit_rate:.1%}")
print(f"tokens reused       : {s.tokens_reused}")
print(f"tokens recomputed   : {s.tokens_computed}")
print(f"KV store unique MB  : {cluster.unique_bytes_stored()/1e6:.2f} "
      f"(logical {cluster.stats.logical_bytes_written/1e6:.2f})")

# a node dies; prefix blocks remain reachable via placement on survivors
victim = list(cluster.nodes)[0]
cluster.crash_node(victim)
r = server.handle(system_prompt + [1, 2, 3, 4, 5, 6, 7, 8], gen_tokens=4)
print(f"\nafter {victim} crash: reused={r['reused_tokens']} (served from replicas/recompute)")
print("serve_prefix_cache OK")
