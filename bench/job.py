"""Runs a training job on the program, operation by operation.

A cell is a configuration (``bench/configs/<name>.json``: the model's
sizes, the batch, the optimizer, the storage cluster and the checkpoint's
chunking) under a traffic mix (``bench/traffic/<name>.json``: the batches'
statistics, the operations set-up makes, and the cycle of operations the
measured window repeats). ``Job`` reads both and drives the program
through its public entry points: ``build_train_step``'s step,
``DedupCheckpointer.save`` / ``restore`` / ``delete`` on a
``DedupCluster``, ``train_state_to_tree`` / ``train_state_from_tree``.

Operations a mix may list:
  {"op": "steps", "n": k}        k train steps, each on the next step's batch;
  {"op": "save"}                 save the state as checkpoint step-<step>;
  {"op": "retain", "keep": k, "gc_ticks": t}
                                 delete all but the newest k checkpoints, then
                                 collect garbage (a sweep, t ticks, a sweep);
  {"op": "crash"}                crash the next storage node in turn, and lose
                                 the job's state on the card;
  {"op": "restore"}              restore the newest checkpoint onto the card;
  {"op": "restart"}              restart the crashed node;
  {"op": "resave"}               save the state as checkpoint resave-<n>.

Every operation is recorded with its host-clock seconds and the spans the
benchmark took inside it (``bench.spans``). What the comparison needs is
kept on the side, off the card, so that the device holds only the program:
the first steps' readings, a pinned host copy of every saved tree (shared
where a leaf did not change; taken before the save's timed span, its
buffers reused once a checkpoint is deleted), each device wave's cut
positions and fingerprints, each restore's bitwise agreement with what was
saved.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from bench import weights as W
from bench.check import expected_bytes
from bench.reference.dedup import row_width
from bench.spans import Spans

# Steps set-up makes before the window, which the reference follows.
FOLLOWED_STEPS = 3


def program_sizes(m: dict, base) -> dict:
    """The configuration's ``model`` keys that are fields of the program's
    ``ModelConfig`` (``base``), with the file's values, which replace the
    registry's."""
    return {f.name: m[f.name] for f in dataclasses.fields(base) if f.name in m}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(host: torch.Tensor, t: torch.Tensor, piece: int = 1 << 26) -> bool:
    """Whether ``host`` (a host copy) holds ``t``'s bits, compared on
    ``t``'s device ``piece`` bytes at a time (the first differing piece
    ends it)."""
    if host.dtype != t.dtype or host.shape != t.shape:
        return False
    a, b = _bits(host).reshape(-1), _bits(t).reshape(-1)
    n = max(1, piece // host.element_size())
    return all(torch.equal(a[i : i + n].to(b.device), b[i : i + n]) for i in range(0, a.numel(), n))


class HostCopies:
    """Host copies of device tensors (pinned where the tensor is on a GPU),
    their buffers reused once given back."""

    def __init__(self):
        self.free: dict[tuple, list[torch.Tensor]] = {}

    def _buffer(self, shape: tuple, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
        pool = self.free.get((shape, dtype))
        return pool.pop() if pool else torch.empty(shape, dtype=dtype, pin_memory=pinned)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        return self._buffer(tuple(t.shape), t.dtype, t.is_cuda).copy_(t.detach())

    def give(self, t: torch.Tensor) -> None:
        self.free.setdefault((tuple(t.shape), t.dtype), []).append(t)

    def reserve(self, like: dict, sets: int, pinned: bool) -> None:
        """Allocate ``sets`` buffers of each of ``like``'s leaves ahead."""
        for t in like.values():
            for _ in range(sets):
                self.give(self._buffer(tuple(t.shape), t.dtype, pinned))


def tree_leaves(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, leaf) of a checkpoint tree in the checkpoint's own order and
    spelling: dict keys sorted, as ``['name']``, sequence indices as
    ``[i]``, joined by "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves(tree[k], f"{path}/[{k!r}]" if path else f"[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves(v, f"{path}/[{i}]" if path else f"[{i}]")]
    return [] if tree is None else [(path, tree)]


def skeleton(tree):
    """``tree``'s structure with 0 for every leaf (a ``like=`` for restore)."""
    if isinstance(tree, dict):
        return {k: skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(skeleton(v) for v in tree)
    return None if tree is None else 0


@dataclasses.dataclass
class Record:
    op: str
    t0: float
    t1: float
    spans: dict
    info: dict

    @property
    def s(self) -> float:
        return self.t1 - self.t0


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", step_fn_wrapper=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.m = config["model"]
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.spans = Spans(torch.cuda.synchronize if self.on_card else None)
        self.records: list[Record] = []
        self.step = 0
        self.step_fn_wrapper = step_fn_wrapper
        self.saved: list[str] = []           # checkpoints not deleted, oldest first
        self.snapshots: dict[str, dict] = {}  # checkpoint -> {key: host tensor}
        self.host = HostCopies()
        self.skeletons: dict[str, object] = {}  # checkpoint -> its tree's structure
        self.expect_ref: dict[str, dict] = {}   # save -> key -> must be written by reference
        self.expect_bytes: dict[str, int] = {}  # save -> bytes it must send
        self.waves: dict[str, list] = {}     # checkpoint -> per-stream (cuts, fps) of its wave
        self.restores: list[dict] = []
        self.crashes = 0
        self.resaves = 0
        self.crashed: str | None = None

    # ---------------------------------------------------------- set-up --
    def build(self, storage: bool = True) -> None:
        """The program's model, its train state from the benchmark's
        weights, its train step, and (where the configuration has one and
        ``storage``) the storage cluster and the checkpointer, with the
        benchmark's spans."""
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train.loop import build_train_step

        c = self.config
        base = get_config(c["arch"])
        self.cfg = dataclasses.replace(base, **program_sizes(self.m, base), **c["program"],
                                       param_dtype=W.DTYPES[self.m["dtype"]])
        self.model = build_model(self.cfg, self.device)
        params = params_from_numpy(W.make_tree(self.m, c["family"], self.seed, self.device), self.cfg, self.device)
        self.opt = AdamWConfig(**c["optimizer"])
        self.state = {"params": params, "opt": adamw_init(dict(params.named_parameters()), self.opt)}
        step_fn = build_train_step(self.model, self.opt, self.m["accum"])
        self.step_fn = self.step_fn_wrapper(step_fn) if self.step_fn_wrapper else step_fn
        if storage and "cluster" in c:
            self._build_cluster()

    def _build_cluster(self) -> None:
        from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
        from repro_torch.checkpoint import dedup_ckpt
        from repro_torch.core import ChunkingSpec, DedupCluster
        from repro_torch.kernels import ops

        cl, cdc = self.config["cluster"], self.config["checkpoint"]
        self.cluster = DedupCluster.create(cl["nodes"], replicas=cl["replicas"],
                                           chunking=ChunkingSpec(cl["chunking"], cl["chunk_bytes"]))
        self.ckpt = DedupCheckpointer(self.cluster, CheckpointConfig(
            fp_chunk_bytes=cdc["target"], cdc_min_bytes=cdc["min"], cdc_max_bytes=cdc["max"]), device=self.device)
        want = {"mask": cdc["mask"], "min_size": cdc["min"], "max_size": cdc["max"]}
        if self.ckpt.spec.kind != "cdc" or self.ckpt.spec.kernel_kwargs() != want:
            raise ValueError(f"the checkpointer chunks as {self.ckpt.spec}, the configuration states {want}")
        sp = self.spans
        sp.wrap(self.ckpt, "_batch_device_fps", "wave", synced=True)
        sp.wrap(dedup_ckpt, "_serialize_leaf", "serialize")
        sp.wrap(self.cluster, "write_objects", "cluster_write")
        sp.wrap(self.cluster, "write_object_by_ref", "ref_write")
        sp.wrap(self.cluster, "read_objects", "read")
        sp.wrap(ops, "cdc_cut_and_fingerprint_many", "cut_and_fingerprint", on_result=self._keep_wave)
        self._wave = None

    def _keep_wave(self, result) -> None:
        self._wave = [(cut[:n_cuts], fps[:n_chunks]) for cut, n_cuts, fps, n_chunks in result]

    def first_steps(self) -> dict:
        """``FOLLOWED_STEPS`` steps through the window's own step and feed,
        from the weights as drawn, and what the comparison reads of them:
        each step's loss, the first step's gradient norm, each leaf's norm
        of the first clipped gradient (its first moment over 1 - b1), and
        each leaf's change over the steps (from a host copy of the weights)."""
        named = dict(self.state["params"].named_parameters())
        start = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
        losses, out = [], {}
        for i in range(FOLLOWED_STEPS):
            metrics = self.train_step()
            losses.append(float(metrics["total_loss"]))
            if i == 0:
                out["grad_norm"] = float(metrics["grad_norm"])
                mu = self.state["opt"]["mu"]
                out["grad_leaf_norms"] = {n: float(mu[n].norm()) / (1 - self.opt.b1) for n in named}
        master = self.state["opt"]["master"]
        out["change_leaf_norms"] = {n: float((master[n] - start[n].to(master[n].device).float()).norm())
                                    for n in named}
        out["losses"] = losses
        return out

    # ------------------------------------------------------- operations --
    def batch(self, step: int) -> dict:
        return W.make_batch(self.m, self.seed, step, self.device)

    def train_step(self) -> dict:
        batch = self.batch(self.step)
        t0 = time.perf_counter()
        with self.spans.op("step") as spans:
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["total_loss"])
        self.records.append(Record("step", t0, time.perf_counter(), spans,
                                   {"tokens": self.m["global_batch"] * self.m["seq_len"], "loss": loss}))
        self.step += 1
        return metrics

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def save(self, name: str) -> None:
        from repro_torch.models.convert import train_state_to_tree

        tree = train_state_to_tree(self.state, self.cfg)
        leaves = tree_leaves(tree)
        prev = self.snapshots.get(self.saved[-1]) if self.saved else None
        snap, same = {}, {}
        for key, t in leaves:
            same[key] = prev is not None and key in prev and same_bits(prev[key], t)
            snap[key] = prev[key] if same[key] else self.host.copy(t)
        self.expect_ref[name], self.expect_bytes[name] = same, expected_bytes(snap, same)
        self._wave = None
        self._sync()
        t0 = time.perf_counter()
        before = dict(self.ckpt.stats)
        with self.spans.op("save") as spans:
            manifest = self.ckpt.save(name, tree)
            self._sync()
        t1 = time.perf_counter()
        stats = {k: v - before[k] for k, v in self.ckpt.stats.items()}
        self.records.append(Record("save", t0, t1, spans, {
            "name": name, "stats": stats, "ref": {e["key"]: e["ref"] for e in manifest["leaves"]},
            "wave": self._wave_info(snap)}))
        self.snapshots[name], self.waves[name], self.skeletons[name] = snap, self._wave, skeleton(tree)
        self.saved.append(name)

    def _wave_info(self, snap: dict) -> dict:
        """The sizes of the save's device wave, for the kernels' bounds."""
        cdc = self.config["checkpoint"]
        sizes = [t.numel() * t.element_size() for t in snap.values()]
        return {"streams": len(sizes), "bytes": sum(sizes),
                "m_cut": sum(n // (cdc["min"] + 1) + 1 for n in sizes),  # the kernel's cut slots
                "chunks": sum(int(f.shape[0]) for _, f in self._wave or []),
                "width": row_width(cdc["max"])[1]}

    def retain(self, keep: int, gc_ticks: int) -> None:
        t0 = time.perf_counter()
        with self.spans.op("retain") as spans:
            while len(self.saved) > keep:
                old = self.saved.pop(0)
                self.ckpt.delete(old)
                self._drop_snapshot(old)
                self.skeletons.pop(old)
                self.waves.pop(old)
            self.cluster.run_gc()
            self.cluster.tick(gc_ticks)
            self.cluster.run_gc()
        self.records.append(Record("retain", t0, time.perf_counter(), spans, {}))

    def _drop_snapshot(self, name: str) -> None:
        """Give back the host buffers of ``name``'s copy that no kept
        checkpoint shares."""
        held = {id(t) for n, snap in self.snapshots.items() if n != name for t in snap.values()}
        for t in self.snapshots.pop(name).values():
            if id(t) not in held:
                held.add(id(t))
                self.host.give(t)

    def reserve_snapshots(self) -> None:
        """Host buffers for the copies the mix's cycle will hold at once
        beyond the newest (as many as its retention keeps), allocated in
        set-up so that no window pins memory."""
        keep = max((op["keep"] for op in self.traffic["cycle"] if op["op"] == "retain"), default=0)
        if self.saved and keep:
            self.host.reserve(self.snapshots[self.saved[-1]], keep, self.on_card)

    def crash(self) -> None:
        nodes = sorted(self.cluster.nodes)
        self.crashed = nodes[self.crashes % len(nodes)]
        self.crashes += 1
        t0 = time.perf_counter()
        self.cluster.crash_node(self.crashed)
        self.state = None
        self.records.append(Record("crash", t0, time.perf_counter(), {}, {"node": self.crashed}))

    def restore(self) -> None:
        from repro_torch.models.convert import train_state_from_tree

        name = self.saved[-1]
        snap = self.snapshots[name]
        like = self.skeletons[name]
        self._sync()
        t0 = time.perf_counter()
        with self.spans.op("restore") as spans:
            tree = self.ckpt.restore(name, like=like)
            self._sync()
        t1 = time.perf_counter()
        differ = [k for k, t in tree_leaves(tree) if k not in snap or not same_bits(snap[k], t)]
        self.restores.append({"name": name, "leaves": len(snap), "differ": differ,
                              "missing": sorted(set(snap) - {k for k, _ in tree_leaves(tree)})})
        self.state = train_state_from_tree(tree, self.cfg, self.device)
        self.step = int(self.state["opt"]["step"])
        self.records.append(Record("restore", t0, t1, spans, {"name": name, "node_down": self.crashed}))

    def restart(self) -> None:
        t0 = time.perf_counter()
        self.cluster.restart_node(self.crashed)
        self.records.append(Record("restart", t0, time.perf_counter(), {}, {"node": self.crashed}))
        self.crashed = None

    def run(self, op: dict, steps: int | None = None) -> None:
        kind = op["op"]
        if kind == "steps":
            for _ in range(op["n"] if steps is None else steps):
                self.train_step()
        elif kind == "save":
            self.save(f"step-{self.step}")
        elif kind == "resave":
            self.resaves += 1
            self.save(f"resave-{self.resaves}")
        elif kind == "retain":
            self.retain(op["keep"], op["gc_ticks"])
        elif kind in ("crash", "restore", "restart"):
            getattr(self, kind)()
        else:
            raise ValueError(f"unknown operation {kind!r}")
