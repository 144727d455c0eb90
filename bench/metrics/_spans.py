"""Reading the program's own spans (``repro_torch.obs``): the stages of a
save, timed inside the program on the host clock the benchmark's records
use (``time.perf_counter``).

A save's spans hang below one ``ckpt.save`` root that carries the
checkpoint's name. ``stage_s`` joins each save the profiler did not see
(``run.untraced("save")``) to its root by that name and by the root's
start lying within the record's interval, sums the seconds of the spans
below the root that have the stage's name, and averages over the saves.
It reads nothing (None) where the program keeps no such log (a checkout
from before the spans), where a save has no root, or where the log's
ring let spans go whose end could lie inside a save.
"""

from __future__ import annotations

import statistics


def program_log():
    """The program's span log (the ``repro_torch.obs`` module: ``spans()``
    and ``dropped()``), or None where the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def save_stages(run, log=None) -> list[dict[str, float]] | None:
    """For each untraced save in the window: seconds by span name below its
    ``ckpt.save`` root, and the root's own under "ckpt.save". None as the
    module says."""
    log = program_log() if log is None else log
    saves = run.untraced("save")
    if log is None or not saves:
        return None
    spans = log.spans()
    if log.dropped() and (not spans or min(s.t1 for s in spans) > min(r.t0 for r in saves)):
        return None
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    out = []
    for r in saves:
        root = next((s for s in spans if s.name == "ckpt.save" and s.attrs.get("name") == r.info["name"]
                     and r.t0 <= s.t0 <= r.t1), None)
        if root is None:
            return None
        stages = {"ckpt.save": root.t1 - root.t0}
        todo = list(children.get(root.id, []))
        while todo:
            s = todo.pop()
            stages[s.name] = stages.get(s.name, 0.0) + (s.t1 - s.t0)
            todo.extend(children.get(s.id, []))
        out.append(stages)
    return out


def stage_s(run, name: str, log=None) -> float | None:
    """Seconds a save spends in the spans named ``name`` below its root,
    over the untraced saves."""
    per_save = save_stages(run, log)
    if per_save is None:
        return None
    return statistics.fmean(stages.get(name, 0.0) for stages in per_save)
