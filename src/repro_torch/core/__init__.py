"""Cluster-wide deduplication for shared-nothing storage — the host cluster.

These modules are host Python plus numpy. The port keeps its own copy of
every one of them, so that ``repro_torch`` imports nothing of any other
package of this repository.

Public API:
    DedupCluster.create(n_nodes, replicas=..., chunking=...)
    cluster.client(presence_cache=..., wave_bytes=...) -> DedupClient
    client.put / put_many / get / get_many / delete / flush / close
    cluster.write_object / write_objects / read_object / read_objects /
        delete_object
    cluster.add_node / remove_node / scrub / run_gc / tick
    ClusterMap, ChunkSpec, ChunkingSpec, Fingerprint, fingerprint_many
"""

from repro_torch.core.chunking import ChunkSpec, ChunkingSpec, chunk_object, window_hashes
from repro_torch.core.client import DedupClient
from repro_torch.core.cluster import (
    DedupCluster,
    ReadError,
    TransactionAbort,
    WriteError,
)
from repro_torch.core.write_cache import (
    PRESENCE_OUTCOMES,
    PendingWrites,
    PresenceCache,
    WriteBackCache,
)
from repro_torch.core.baselines import (
    CentralDedupCluster,
    DiskLocalDedupCluster,
    NoDedupCluster,
    UnsupportedTransportPolicy,
)
from repro_torch.core.dmshard import CITEntry, DMShard, INVALID, OMAPEntry, VALID
from repro_torch.core.messages import (
    ACK_MSG_BYTES,
    CONTROL_MSG_BYTES,
    DIGEST_ENTRY_BYTES,
    DIGEST_GROUP_BYTES,
    OMAP_DIGEST_ENTRY_BYTES,
    RECIPE_REF_BYTES,
    TOMBSTONE_RECORD_BYTES,
    ChunkOp,
    ChunkOpBatch,
    ChunkRead,
    ChunkReadBatch,
    ChunkReadBatchReply,
    DecrefBatch,
    DigestReply,
    DigestRequest,
    Message,
    MigrateChunk,
    OmapDelete,
    OmapGet,
    OmapPut,
    PRESENCE_FP_BYTES,
    PresenceInvalidate,
    RawPut,
    RefAudit,
    RefOnlyWrite,
    RepairChunk,
    TombstoneReap,
    TxnCancel,
)
from repro_torch.core.node import DirtyTracker, StorageNode
from repro_torch.core.recovery import (
    RecoveryReport,
    RecoveryRound,
    RepairDaemon,
    repair_round,
    run_recovery,
)
from repro_torch.core.transport import (
    Envelope,
    MessageDropped,
    SeenWindow,
    Transport,
    ack_loss,
    chaos,
    delay,
    drop,
    duplicate,
    partition,
    reliable,
    reorder,
)
from repro_torch.core.fingerprint import (
    Fingerprint,
    chain_fp,
    fingerprint_many,
    name_fp,
    object_fp,
    sha256_fp,
)
from repro_torch.core.placement import ClusterMap, place, primary
from repro_torch.core.simclock import Scheduler, SimClock
from repro_torch.core.workload import ClientRecord, WorkloadOp, WorkloadSpec, run_workload

__all__ = [
    "ChunkSpec",
    "ChunkingSpec",
    "chunk_object",
    "window_hashes",
    "fingerprint_many",
    "DedupClient",
    "DedupCluster",
    "PRESENCE_OUTCOMES",
    "PendingWrites",
    "PresenceCache",
    "WriteBackCache",
    "CentralDedupCluster",
    "DiskLocalDedupCluster",
    "NoDedupCluster",
    "UnsupportedTransportPolicy",
    "ReadError",
    "TransactionAbort",
    "WriteError",
    "CITEntry",
    "DMShard",
    "INVALID",
    "VALID",
    "OMAPEntry",
    "Fingerprint",
    "chain_fp",
    "name_fp",
    "object_fp",
    "sha256_fp",
    "ClusterMap",
    "place",
    "primary",
    "ACK_MSG_BYTES",
    "CONTROL_MSG_BYTES",
    "DIGEST_ENTRY_BYTES",
    "DIGEST_GROUP_BYTES",
    "OMAP_DIGEST_ENTRY_BYTES",
    "RECIPE_REF_BYTES",
    "TOMBSTONE_RECORD_BYTES",
    "Message",
    "ChunkOp",
    "ChunkOpBatch",
    "ChunkRead",
    "ChunkReadBatch",
    "ChunkReadBatchReply",
    "DecrefBatch",
    "DigestReply",
    "DigestRequest",
    "MigrateChunk",
    "OmapDelete",
    "OmapGet",
    "OmapPut",
    "PRESENCE_FP_BYTES",
    "PresenceInvalidate",
    "RawPut",
    "RefAudit",
    "RefOnlyWrite",
    "RepairChunk",
    "TombstoneReap",
    "TxnCancel",
    "DirtyTracker",
    "StorageNode",
    "RecoveryReport",
    "RecoveryRound",
    "RepairDaemon",
    "repair_round",
    "run_recovery",
    "Transport",
    "Envelope",
    "SeenWindow",
    "MessageDropped",
    "reliable",
    "drop",
    "delay",
    "partition",
    "duplicate",
    "reorder",
    "ack_loss",
    "chaos",
    "Scheduler",
    "SimClock",
    "ClientRecord",
    "WorkloadOp",
    "WorkloadSpec",
    "run_workload",
]
