"""Quickstart: cluster-wide dedup in 60 seconds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``: the model and its checkpoint run on
CUDA unless ``--device`` names another device.
"""

import argparse
import os

from repro_torch.checkpoint import DedupCheckpointer
from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.models import build_model
from repro_torch.models.convert import params_tree

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: cuda)")
args = ap.parse_args()

# 1. A shared-nothing storage cluster: 4 OSS nodes, 2-way replication.
cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 64 * 1024))

# 2. Objects are chunked, content-fingerprinted, and placed cluster-wide by
#    fingerprint. Duplicate content is stored once — across ALL nodes.
blob = os.urandom(1 << 20)
cluster.write_object("vm-image-a", blob)
cluster.write_object("vm-image-b", blob)          # full duplicate
cluster.write_object("vm-image-c", blob + os.urandom(1 << 18))  # 80% duplicate
cluster.tick(2)                                    # async commit-flag flips

print(f"logical bytes written : {cluster.stats.logical_bytes_written/1e6:7.2f} MB")
print(f"unique bytes stored   : {cluster.unique_bytes_stored()/1e6:7.2f} MB")
print(f"space savings         : {100*cluster.space_savings():7.1f} %")
assert cluster.read_object("vm-image-b") == blob

# 3. Fault tolerance: a node dies; reads fall over to replicas.
cluster.crash_node("oss1")
assert cluster.read_object("vm-image-a") == blob
cluster.restart_node("oss1")
print("node failure survived : reads served from replicas")

# 4. Elastic scaling: add a node — chunks rebalance by pure placement math,
#    dedup metadata needs ZERO location updates (the paper's key property).
cluster.add_node()
assert cluster.read_object("vm-image-c")[: 1 << 20] == blob
print(f"rebalance moved       : {cluster.stats.rebalance_chunks_moved} chunks, "
      f"metadata rewrites: 0")

# 5. The framework integration: deduplicated model checkpoints of the JAX
#    package's parameter tree (``params_tree``).
model = build_model(get_config("qwen2.5-32b").reduced(), device=args.device)
params = params_tree(model.init(0), model.cfg)
ck = DedupCheckpointer(cluster, device=model.device)
ck.save("step-100", params)
ck.save("step-200", params)   # unchanged tensors -> reference-only writes
print(f"ckpt ref-only leaves  : {ck.stats['leaves_ref_only']} "
      f"(device-fingerprint fast path, no data motion)")
print("quickstart OK")
