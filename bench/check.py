"""How ``correct`` is decided: the plain reference (``bench.reference``) is
run once the window has closed and the program's state is freed, and each
number compared is held to its limit (``bench/limits/<config>.json``).

Training (every cell): the reference follows the job's first steps from
the same weights and batches. Compared, each as a relative gap to the
reference: every step's loss (the worst step), the first step's gradient
norm, each leaf's norm of the first clipped gradient and each leaf's
change over the steps (against the larger of the leaf's own reference
norm and the median leaf's; the worst leaf, and the median leaf's gap,
which is steady from seed to seed where the worst swings). Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change: they move by rounding alone.

Checkpoints (cells with a cluster), exact: every checkpoint kept at the
window's close read back from every node's records and chunks, each
object on as many replicas as the configuration states; every manifest's
reference flags against whether each leaf changed since the save before;
every save's bytes sent against the serialized bytes of the leaves it had
to write; the cut positions and fingerprints of every kept save's device
wave (the longest stream and a seed's sample of the others); each
restore bitwise against the tree that was saved. The job keeps what was
saved in host memory (``bench.job``); the waves are worked out again on
the job's device once the program's state is freed.
"""

from __future__ import annotations

import random
import statistics

import torch

from bench import weights as W
from bench.families import family
from bench.reference import dedup as D
from bench.reference import models as M
from bench.reference import train as T


# Streams of each kept save's device wave held to the reference besides the
# longest: drawn from the seed.
WAVE_SAMPLE = 2


def reference_readings(config: dict, seed: int, device, steps: int) -> dict:
    """The reference's readings of the job's first ``steps`` steps."""
    m = config["model"]
    M.plain_float32()
    tree = W.make_tree(m, config["family"], seed, device)
    params = T.map_tree(lambda t: t.float(), tree)
    del tree
    batches = []
    for step in range(steps):
        batch = {k: (v.float() if v.is_floating_point() else v)
                 for k, v in W.make_batch(m, seed, step, device).items()}
        batches.append(W.microbatches(batch, m["accum"]))
    return T.follow(params, m, config["optimizer"], batches, family(config["family"]).loss)


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor)


def training_numbers(program: dict, ref: dict) -> dict:
    """The training gaps (see the module's notes)."""
    out = {"loss_gap": max(_gap(p, r, 0.0) for p, r in zip(program["losses"], ref["losses"])),
           "grad_norm_gap": _gap(program["grad_norm"], ref["grad_norm"], 0.0)}
    rg = ref["grad_leaf_norms"]
    med = statistics.median(rg.values())
    gaps = [_gap(program["grad_leaf_norms"][n], r, med) for n, r in rg.items()]
    out["grad_leaf_gap"], out["grad_median_gap"] = max(gaps), statistics.median(gaps)
    kept = [n for n, r in rg.items() if r >= 1e-3 * med]
    rc = ref["change_leaf_norms"]
    med_c = statistics.median(rc[n] for n in kept)
    gaps = [_gap(program["change_leaf_norms"][n], rc[n], med_c) for n in kept]
    out["change_leaf_gap"], out["change_median_gap"] = max(gaps), statistics.median(gaps)
    out["_left_out"] = sorted(set(rg) - set(kept))
    return out


def checkpoint_numbers(job, seed: int) -> dict:
    """The exact checkpoint counts (see the module's notes): each is 0 in a
    correct run. Faults found go to ``_faults``."""
    cfg, cl, cdc = job.config, job.config["cluster"], job.config["checkpoint"]
    prefix = job.ckpt.cfg.prefix
    faults: list[str] = []
    # every save's reference flags and bytes sent
    flag_bad = bytes_gap = 0
    for r in job.records:
        if r.op != "save":
            continue
        name = r.info["name"]
        want = job.expect_ref[name]
        flag_bad += sum(r.info["ref"].get(k) != v for k, v in want.items())
        bytes_gap += abs(r.info["stats"]["bytes_sent"] - job.expect_bytes[name])
    # every kept checkpoint on its replicas
    ckpt_faults, seen = [], set()
    for name in job.saved:
        ckpt_faults += D.check_checkpoint(job.cluster, prefix, name, job.snapshots[name], job.expect_ref[name],
                                          cl["chunk_bytes"], cl["replicas"], seen)
    faults += ckpt_faults[:5]
    # every kept save's device wave
    wave_bad = 0
    verified: list[tuple[dict, list]] = []
    for name in job.saved:
        snap, wave = job.snapshots[name], job.waves[name]
        keys = list(snap)
        if wave is None or len(wave) != len(keys):
            wave_bad += 1
            faults.append(f"{name}: wave of {None if wave is None else len(wave)} streams, {len(keys)} leaves")
            continue
        if any(all(snap[k] is vs[k] for k in keys) and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                                                           for a, b in zip(wave, vw)) for vs, vw in verified):
            continue  # the same inputs and outputs as a wave already held to the reference
        sizes = [snap[k].numel() * snap[k].element_size() for k in keys]
        longest = max(range(len(keys)), key=sizes.__getitem__)
        rng = random.Random(W.sub_seed(seed, "wave", name))
        others = [i for i in range(len(keys)) if i != longest]
        picks = [longest] + rng.sample(others, min(WAVE_SAMPLE, len(others)))
        for i in picks:
            data = D.stream_of(snap[keys[i]].to(job.device))
            cuts = D.cut_positions(data, cdc["mask"], cdc["min"], cdc["max"])
            got_cuts, got_fps = wave[i]
            ok = got_cuts.cpu().tolist() == cuts
            if ok:
                fps = D.stream_fingerprints(data, cuts, cdc["max"])
                ok = torch.equal(fps.cpu(), got_fps.view(torch.int32).to(torch.int64).cpu() & D.U32)
            if not ok:
                wave_bad += 1
                faults.append(f"{name}: stream {keys[i]} cut or fingerprinted unlike the reference")
        verified.append((snap, wave))
    restore_bad = sum(len(r["differ"]) + len(r["missing"]) for r in job.restores)
    for r in job.restores:
        if r["differ"] or r["missing"]:
            faults.append(f"restore of {r['name']}: {len(r['differ'])} leaves differ, {len(r['missing'])} missing")
    return {"ckpt_faults": len(ckpt_faults), "ref_flag_mismatches": flag_bad, "bytes_sent_gap": bytes_gap,
            "wave_mismatches": wave_bad, "restore_mismatches": restore_bad, "_faults": faults}


def expected_bytes(snap: dict, same: dict) -> int:
    """Bytes a save must send: the serialized leaves that changed."""
    return sum(D.serialized_len(t) for k, t in snap.items() if not same[k])


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}). A number whose limit is null
    is reported and not compared."""
    table, ok = {}, True
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits[name]
        table[name] = {"value": value, "limit": limit if limit is not None else "not compared"}
        if limit is not None and not value <= limit:
            ok = False
    return ok, table
