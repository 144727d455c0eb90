"""Failure-injection drill for the storage substrate — every failure mode
the paper's tagged consistency must survive, end to end:

  1. crash before async flag flip      -> repair on duplicate write
  2. transaction abort mid-object      -> garbage chunks -> GC collects
  3. node dies permanently             -> replicas serve; scrub re-protects
  4. topology change under load        -> zero metadata-location rewrites

    PYTHONPATH=src python -m repro_torch.examples.failure_recovery [--device cpu]

The port of ``examples/failure_recovery.py`` over ``repro_torch.core``. The
drill runs on the host only; ``--device`` is taken, as by the other
examples, and nothing here runs on it.
"""

import argparse
import os

from repro_torch.core import ChunkingSpec, DedupCluster, TransactionAbort, WriteError
from repro_torch.core.placement import place

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (unused: the drill is host-only)")
ap.parse_args()

cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 64 * 1024))
payload = os.urandom(1 << 20)

# -- 1. crash window between data write and async flag flip -----------------
cluster.write_object("doc-v1", payload)          # flips still queued
for node in cluster.nodes.values():
    node.crash()                                 # power failure: queue lost
for node in cluster.nodes.values():
    node.restart()
invalid = sum(len(n.shard.invalid_fps()) for n in cluster.nodes.values())
print(f"[1] invalid flags after crash: {invalid} (chunks on disk, flips lost)")
cluster.write_object("doc-v2", payload)          # duplicate write repairs
repairs = sum(n.stats.repairs for n in cluster.nodes.values())
print(f"[1] consistency-check repairs: {repairs}; read-back ok: "
      f"{cluster.read_object('doc-v1') == payload}")

# -- 2. failed transaction leaves garbage; GC collects it --------------------
def bomb(event, ctx):
    if event == "before_chunk_op" and ctx["name"] == "doomed" and ctx["index"] == 8:
        raise TransactionAbort("client died mid-write")

cluster.fault_injector = bomb
try:
    cluster.write_object("doomed", os.urandom(1 << 20))
except WriteError as e:
    print(f"[2] transaction failed as injected: {type(e).__name__}")
cluster.fault_injector = None
garbage = sum(len(n.shard.invalid_fps()) for n in cluster.nodes.values())
cluster.tick(20); cluster.run_gc()
cluster.tick(20)
collected = sum(len(v) for v in cluster.run_gc().values())
print(f"[2] garbage chunks: {garbage}, GC collected: {collected} "
      f"(no journal, flags were the garbage markers)")

# -- 3. permanent node loss ---------------------------------------------------
victim = list(cluster.nodes)[1]
cluster.crash_node(victim)
print(f"[3] {victim} dead; read ok: {cluster.read_object('doc-v1') == payload}")
cluster.restart_node(victim)
cluster.nodes[victim].chunk_store.clear()        # disk wiped
cluster.nodes[victim].shard.cit.clear()
restored = cluster.scrub()
print(f"[3] scrub restored {restored} chunk copies to the replacement disk")

# -- 4. elastic rescale under data -------------------------------------------
before = sum(len(n.chunk_store) for n in cluster.nodes.values())
cluster.add_node()
moved = cluster.stats.rebalance_chunks_moved
print(f"[4] +1 node: moved {moved}/{before} chunk copies "
      f"({100*moved/max(before,1):.0f}%, HRW minimal movement)")
for nid, node in cluster.nodes.items():
    for fp in node.shard.cit:
        assert nid in place(fp, cluster.cmap), "metadata off placement!"
print("[4] every CIT entry located purely by place(fp, map): 0 location rewrites")
print(f"final read ok: {cluster.read_object('doc-v2') == payload}")
print("failure_recovery OK")
