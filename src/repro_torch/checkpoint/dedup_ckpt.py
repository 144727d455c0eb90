"""Deduplicated, fault-tolerant distributed checkpointing of torch tensors.

The paper's technique as a framework feature:

* every leaf of a nested dict / list / tuple of tensors is serialized,
  chunked, SHA-256-fingerprinted and placed *cluster-wide by content
  fingerprint* on the shared-nothing DedupCluster;
* repeated checkpoints dedup against each other;
* commit flags + GC make a crash mid-save harmless (no journal);
* restore goes through the read path's consistency check, which repairs
  missing/invalid chunks from replicas.

Device-fingerprint fast path (beyond the paper): before pulling a tensor to
the host, name its content-defined chunks on the card (one CDC launch + one
fingerprint launch for the whole tree) and compare with the previous save;
unchanged tensors are written by *reference* (refcount-only unicasts, no
data motion). A failing device fingerprint raises; nothing falls back.

Leaf keys, object names and stored bytes are the same as the JAX package's
``repro.checkpoint`` writes for the same tree, so a checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.core import DedupCluster, ReadError
from repro_torch.core.chunking import ChunkSpec
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    prefix: str = "ckpt"
    device_fp_fastpath: bool = True
    # Chunking of the device-fingerprint fast path: kind "cdc" + device=True
    # runs the fused chunk+fingerprint pipeline (ONE CDC launch + ONE
    # fingerprint launch per save wave); kind "fixed" runs fixed-size
    # chunking via fingerprint_tensor_chunks_many (one fingerprint launch).
    # When unset, built from the legacy fields below.
    chunk_spec: ChunkSpec | None = None
    fp_chunk_bytes: int = 512 * 1024
    device_cdc: bool = True
    cdc_min_bytes: int = 0      # 0 -> fp_chunk_bytes // 2
    cdc_max_bytes: int = 0      # 0 -> fp_chunk_bytes * 2
    # Streaming ingest: bound the transport wave for the batched leaf write
    # (0 = one wave for the whole checkpoint).
    wave_bytes: int = 0
    # Fingerprint presence-cache capacity for the writing session (0 = off).
    presence_cache: int = 0

    def resolved_chunk_spec(self) -> ChunkSpec:
        if self.chunk_spec is not None:
            return self.chunk_spec
        return ChunkSpec.for_checkpoint(
            self.fp_chunk_bytes,
            min_bytes=self.cdc_min_bytes,
            max_bytes=self.cdc_max_bytes,
            device=self.device_cdc,
        )


def _walk(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """Apply ``fn(key, leaf)`` to every leaf, rebuilding the containers.

    Keys spell what JAX's ``tree_flatten_with_path`` spells, joined with
    "/": dict keys as ``['name']`` (a ``dict`` visited in sorted order, an
    ``OrderedDict`` in its own), namedtuple fields as ``.name``, list and
    tuple indices as ``[0]``. ``None`` holds no leaf. Each container is
    rebuilt as its own type."""
    if isinstance(tree, collections.OrderedDict):
        return type(tree)((k, _walk(v, fn, _join(path, f"[{k!r}]"))) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, _join(path, f"[{k!r}]")) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*(_walk(getattr(tree, f), fn, _join(path, f".{f}")) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, _join(path, f"[{i}]")) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    _walk(tree, lambda key, leaf: out.append((key, leaf)))
    return out


def _serialize_leaf(leaf) -> bytes:
    """A leaf's stored bytes: a 4-byte header length, a JSON header (dtype,
    shape) and the raw elements. Spans ``ckpt.serialize`` around
    ``ckpt.d2h`` (the leaf onto the host) and ``ckpt.encode`` (the bytes)."""
    with obs.span("ckpt.serialize") as attrs:
        with obs.span("ckpt.d2h") as d2h:
            if isinstance(leaf, torch.Tensor):
                host = _as_tensor(leaf).contiguous().cpu()
                d2h["bytes"], d2h["pinned"] = host.numel() * host.element_size(), host.is_pinned()
            else:
                host = np.asarray(leaf)
                d2h["bytes"], d2h["pinned"] = host.nbytes, False
        with obs.span("ckpt.encode") as enc:
            if isinstance(host, torch.Tensor):
                if host.dtype == torch.bfloat16:
                    arr, dtype_name = host.view(torch.uint16).numpy(), "bfloat16"
                else:
                    arr = host.numpy()
                    dtype_name = arr.dtype.name
            else:
                arr, dtype_name = host, host.dtype.name
            header = json.dumps({"dtype": dtype_name, "shape": list(arr.shape)}).encode()
            data = len(header).to_bytes(4, "big") + header + arr.tobytes()
            enc["bytes"] = attrs["bytes"] = len(data)
        # the host copy is freed here, inside the span, not after it
        del host, arr
    return data


def _deserialize_leaf(data: bytes, device: torch.device) -> torch.Tensor:
    hlen = int.from_bytes(data[:4], "big")
    meta = json.loads(data[4 : 4 + hlen].decode())
    raw = data[4 + hlen :]
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, np.uint16).reshape(meta["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(meta["shape"])
    return torch.from_numpy(arr.copy()).to(device)


# numpy dtype kinds with a torch counterpart: bool, signed and unsigned
# integers, floats and complex numbers; and bfloat16 by name (``ml_dtypes``
# spells it as kind "V", what ``np.asarray`` gives for a JAX bf16 array).
_NUMERIC_KINDS = frozenset("biufc")


def _is_bf16(dtype: Any) -> bool:
    return np.dtype(dtype).name == "bfloat16"


def _on_fast_path(leaf: Any) -> bool:
    """Whether a leaf's chunks are named on the device: every leaf with a
    ``dtype``, as the JAX package takes them, except a numpy one of a kind
    torch cannot hold (object, str, bytes, void, datetime), which is only
    ever written in full."""
    if isinstance(leaf, torch.Tensor):
        return True
    if not hasattr(leaf, "dtype"):
        return False
    return np.dtype(leaf.dtype).kind in _NUMERIC_KINDS or _is_bf16(leaf.dtype)


def _as_tensor(leaf: Any) -> torch.Tensor:
    """A fast-path leaf as a tensor on its own device (numpy on the CPU;
    a numpy bfloat16 leaf through its ``uint16`` bits, the same bytes). A
    DTensor leaf is taken whole, as the JAX package takes a sharded array."""
    if isinstance(leaf, DTensor):
        return leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.ascontiguousarray(leaf)
    if _is_bf16(arr.dtype):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class DedupCheckpointer:
    """Saves and restores trees of tensors on a DedupCluster.

    ``device`` is where chunks are named and restored tensors land: CUDA
    unless the caller passes another (the tests pass ``"cpu"``); with no
    CUDA device and none passed, construction raises."""

    def __init__(
        self,
        cluster: DedupCluster,
        cfg: CheckpointConfig | None = None,
        device: "str | torch.device | None" = None,
    ):
        self.cluster = cluster
        self.cfg = cfg or CheckpointConfig()
        self.device = kops.resolve_device(device)
        self.spec = self.cfg.resolved_chunk_spec()
        # The writing session: a dedicated DedupClient when streaming waves
        # or a presence cache are configured, else the cluster's default
        # (cache-disabled) session.
        if self.cfg.wave_bytes or self.cfg.presence_cache:
            self.session = cluster.client(
                presence_cache=self.cfg.presence_cache,
                wave_bytes=self.cfg.wave_bytes,
            )
        else:
            self.session = None
        # leafpath -> (device fp bytes, object name last written)
        self._last_device_fps: dict[str, tuple[bytes, str]] = {}
        self.stats = {
            "leaves_written": 0,
            "leaves_ref_only": 0,
            "bytes_sent": 0,
            # kernel-launch accounting for the device fast path: one CDC
            # launch + one fingerprint launch per save wave
            "cdc_launches": 0,
            "fp_launches": 0,
        }

    # ------------------------------------------------------------------ save
    def save(self, name: str, tree: Any) -> dict[str, Any]:
        """Save ``tree`` as checkpoint ``name``; returns its manifest. The
        span ``ckpt.save`` (``name``, ``leaves``, ``bytes`` sent) is the
        root of every span the save opens."""
        leaves = _leaf_paths(tree)
        with obs.span("ckpt.save", name=name, leaves=len(leaves)) as attrs:
            # Batched device fingerprinting: one kernel launch pair for ALL
            # leaves with a dtype (``_on_fast_path``), then per-leaf ref-write
            # decisions.
            fp_cache = self._batch_device_fps(leaves)
            manifest = {"name": name, "leaves": []}
            full_writes: list[tuple[str, bytes]] = []
            for key, leaf in leaves:
                obj_name = f"{self.cfg.prefix}/{name}/{key}"
                if self._ref_write(key, obj_name, fp_cache.get(key)):
                    manifest["leaves"].append({"key": key, "object": obj_name, "ref": True})
                    self.stats["leaves_ref_only"] += 1
                    continue
                data = _serialize_leaf(leaf)
                full_writes.append((obj_name, data))
                manifest["leaves"].append({"key": key, "object": obj_name, "ref": False})
            mbytes = json.dumps(manifest).encode()
            # One batched write transaction for all full leaves + the manifest.
            # write_objects commits items in order and raises at the first
            # failure, so the writes_ok delta counts exactly the committed leaves.
            writer = (
                self.session.put_many
                if self.session is not None
                else self.cluster.write_objects
            )
            ok_before = self.cluster.stats.writes_ok
            try:
                writer(
                    full_writes + [(f"{self.cfg.prefix}/{name}/MANIFEST", mbytes)]
                )
            finally:
                committed = min(self.cluster.stats.writes_ok - ok_before, len(full_writes))
                attrs["bytes"] = sum(len(d) for _, d in full_writes[:committed])
                self.stats["leaves_written"] += committed
                self.stats["bytes_sent"] += attrs["bytes"]
            # drain async flag flips (the paper's consistency manager)
            self.cluster.tick(2)
        return manifest

    def _batch_device_fps(self, leaves: list[tuple[str, Any]]) -> dict[str, bytes]:
        """Chunk + fingerprint every leaf with a dtype on the device —
        with CDC the whole tree goes through ONE fused CDC launch plus ONE
        fingerprint launch; with fixed-size chunking, one fingerprint
        launch. Returns leafpath -> raw fingerprint bytes."""
        if not self.cfg.device_fp_fastpath:
            return {}
        arr = [(k, leaf) for k, leaf in leaves if _on_fast_path(leaf)]
        if not arr:
            return {}
        with obs.span("ckpt.wave", streams=len(arr)) as attrs:
            tensors = [_as_tensor(leaf).to(self.device) for _, leaf in arr]
            attrs["bytes"] = sum(t.numel() * t.element_size() for t in tensors)
            before = kops.launch_snapshot()
            try:
                if self.spec.kind == "cdc":
                    out = self._fused_device_fps(tensors)
                else:
                    fps = kops.fingerprint_tensor_chunks_many(tensors, self.spec.target_bytes)
                    out = [f.cpu().numpy().tobytes() for f in fps]
            finally:
                after = kops.launch_snapshot()
                self.stats["cdc_launches"] += after["cdc"] - before["cdc"]
                self.stats["fp_launches"] += after["fingerprint"] - before["fingerprint"]
        return {k: fp for (k, _), fp in zip(arr, out)}

    def _fused_device_fps(self, tensors: list[torch.Tensor]) -> list[bytes]:
        """One fused chunk+fingerprint wave over every tensor's byte stream.
        Per-leaf fingerprint bytes = the concatenated per-chunk device
        fingerprints (CDC chunk boundaries, so any content change perturbs
        both the chunking and the fingerprints)."""
        streams = [kops.tensor_to_u8(t) for t in tensors]
        res = kops.cdc_cut_and_fingerprint_many(streams, spec=self.spec)
        return [fps[:n_chunks].cpu().numpy().tobytes() for _, _, fps, n_chunks in res]

    def _ref_write(self, key: str, obj_name: str, fp_bytes: bytes | None) -> bool:
        """Device-fp fast path: if the tensor is unchanged since the last
        save (per its device fingerprint), create the new object as a
        reference-only write against the previous one — refcount unicasts,
        zero data motion. Returns True on success."""
        if fp_bytes is None:
            return False
        prev = self._last_device_fps.get(key)
        self._last_device_fps[key] = (fp_bytes, obj_name)
        if prev is None or prev[0] != fp_bytes:
            return False
        ofp = self.cluster.write_object_by_ref(obj_name, prev[1])
        return ofp is not None

    # --------------------------------------------------------------- restore
    def restore(self, name: str, like: Any | None = None) -> Any:
        mbytes = self.cluster.read_object(f"{self.cfg.prefix}/{name}/MANIFEST")
        manifest = json.loads(mbytes.decode())
        # One coalesced restore for every leaf: leaves sharing chunks are
        # fetched once per batch, and each node serves its chunks in one
        # ChunkReadBatch.
        ents = manifest["leaves"]
        blobs = self.cluster.read_objects([ent["object"] for ent in ents])
        leaves = {
            ent["key"]: _deserialize_leaf(data, self.device)
            for ent, data in zip(ents, blobs)
        }
        if like is None:
            return leaves

        def _take(key: str, _leaf: Any) -> torch.Tensor:
            if key not in leaves:
                raise ReadError(f"checkpoint {name} missing leaf {key}")
            return leaves[key]

        return _walk(like, _take)

    def delete(self, name: str) -> None:
        mbytes = self.cluster.read_object(f"{self.cfg.prefix}/{name}/MANIFEST")
        manifest = json.loads(mbytes.decode())
        # ref'd objects belong to an earlier checkpoint; delete only our own
        own = {e["object"] for e in manifest["leaves"] if not e.get("ref")}
        for obj in own:
            self.cluster.delete_object(obj)
        self.cluster.delete_object(f"{self.cfg.prefix}/{name}/MANIFEST")

    def list_checkpoints(self) -> list[str]:
        names = set()
        for node in self.cluster.nodes.values():
            for name in node.shard.omap:
                if name.startswith(self.cfg.prefix + "/") and name.endswith("/MANIFEST"):
                    names.add(name.split("/")[1])
        return sorted(names)
