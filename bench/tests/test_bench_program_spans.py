"""The readers of the program's own save spans (``bench/metrics/_spans.py``
and the eight stage metrics): over a synthetic run and span log, they leave
out the saves the profiler saw, join a save to its root by the
checkpoint's name, and read nothing where the log let spans go or the
program keeps none; a tiny traced run on the CPU reports them in the
checkpointing cell only."""

import pytest

from conftest import tiny_cell
from repro_torch.obs import Span

STAGES = {"ckpt_d2h_s": "ckpt.d2h", "ckpt_encode_s": "ckpt.encode", "ckpt_chunk_s": "cluster.chunk",
          "ckpt_sha256_s": "cluster.sha256", "ckpt_plan_s": "cluster.plan", "ckpt_send_s": "cluster.send",
          "ckpt_commit_s": "cluster.commit", "ckpt_flags_s": "cluster.tick"}
SEED = 2**31 + 977


class Log:
    """A stand-in for ``repro_torch.obs``: a fixed snapshot and a dropped count."""

    def __init__(self, spans, dropped=0):
        self._spans, self._dropped = spans, dropped

    def spans(self):
        return list(self._spans)

    def dropped(self):
        return self._dropped


def _save_spans(first_id, name, t0, stage_s):
    """A save's root at ``t0`` named ``name``, and below it (through a
    ``ckpt.serialize`` and a ``cluster.put_many``) one span per stage of
    ``stage_s`` seconds, each stage twice where it runs per leaf or node."""
    root = Span(first_id, None, "ckpt.save", t0, t0 + 10.0, {"name": name})
    ser = Span(first_id + 1, root.id, "ckpt.serialize", t0 + 1, t0 + 3, {})
    put = Span(first_id + 2, root.id, "cluster.put_many", t0 + 3, t0 + 9, {})
    out, i = [root, ser, put], first_id + 3
    for stage in STAGES.values():
        parent = ser.id if stage.startswith("ckpt.") else put.id if stage != "cluster.tick" else root.id
        for _ in range(2 if stage in ("ckpt.d2h", "ckpt.encode", "cluster.send") else 1):
            out.append(Span(i, parent, stage, t0 + 4, t0 + 4 + stage_s, {}))
            i += 1
    return out


def _view(records, traced):
    from bench.job import Record
    from bench.run import RunView

    class Job:
        config, traffic = {"model": {}}, {}

    Job.records = [Record("save", a, b, {}, {"name": n}) for n, a, b in records]
    return RunView(Job, 0, 1000, 1.0, None, traced)


def _read(metric, view, log):
    from bench.metrics import _spans

    return _spans.stage_s(view, STAGES[metric], log)


def test_readers_leave_out_the_saves_the_profiler_saw():
    view = _view([("step-32", 100, 111), ("step-64", 200, 211), ("step-96", 300, 311)], traced=(150, 250))
    log = Log(_save_spans(1, "step-32", 100.5, 0.5) + _save_spans(100, "step-64", 200.5, 9.0)
              + _save_spans(200, "step-96", 300.5, 1.5))
    assert _read("ckpt_sha256_s", view, log) == pytest.approx(1.0)
    assert _read("ckpt_send_s", view, log) == pytest.approx(2.0)  # two nodes a save
    assert _read("ckpt_d2h_s", view, log) == pytest.approx(2.0)  # two leaves a save


def test_readers_join_each_save_by_the_checkpoints_name_and_time():
    """A root of another name, or of the same name outside the record's
    interval (an earlier run in the same process), is not the save's."""
    view = _view([("step-32", 100, 111)], traced=None)
    decoys = _save_spans(1, "step-64", 100.5, 7.0) + _save_spans(100, "step-32", 20.0, 5.0)
    log = Log(decoys + _save_spans(200, "step-32", 100.5, 0.25))
    for metric in STAGES:
        want = 0.5 if metric in ("ckpt_d2h_s", "ckpt_encode_s", "ckpt_send_s") else 0.25
        assert _read(metric, view, log) == pytest.approx(want), metric
    # the flag flips counted are the ticks below the save's root only
    stray_tick = Span(999, None, "cluster.tick", 105.0, 106.0, {})
    assert _read("ckpt_flags_s", view, Log(log.spans() + [stray_tick])) == pytest.approx(0.25)
    # no root for the save: nothing to read
    assert _read("ckpt_plan_s", view, Log(decoys)) is None


def test_readers_read_nothing_where_the_ring_let_spans_go():
    view = _view([("step-32", 100, 111)], traced=None)
    spans = _save_spans(1, "step-32", 100.5, 0.25)
    assert _read("ckpt_commit_s", view, Log(spans, dropped=3)) is None
    # spans let go long before the save started cannot be the save's
    old = Span(0, None, "cluster.tick", 10.0, 11.0, {})
    assert _read("ckpt_commit_s", view, Log([old] + spans, dropped=3)) == pytest.approx(0.25)


def test_readers_read_nothing_without_an_untraced_save_or_a_program_log(monkeypatch):
    from bench.metrics import _spans

    spans = _save_spans(1, "step-32", 100.5, 0.25)
    assert _read("ckpt_chunk_s", _view([("step-32", 100, 111)], traced=(90, 120)), Log(spans)) is None
    assert _read("ckpt_chunk_s", _view([], traced=None), Log(spans)) is None
    monkeypatch.setattr(_spans, "program_log", lambda: None)
    assert _spans.stage_s(_view([("step-32", 100, 111)], traced=None), "cluster.chunk") is None


@pytest.mark.parametrize("workload", ["mamba2-1.3b.train_ckpt", "llava-next-7b.train"])
def test_a_tiny_traced_run_reports_the_stages_in_the_checkpointing_cell_only(cpu_threads, workload):
    from bench.run import run_cell

    bench, cell, config, traffic, limits = tiny_cell(workload)
    res = run_cell(bench, cell, config, traffic, limits, SEED, 0.5, True, device="cpu")
    got = {m: res["metrics"][m]["value"] for m in STAGES if m in res["metrics"]}
    if workload == "llava-next-7b.train":
        assert got == {}
    else:
        assert set(got) == set(STAGES) and all(v > 0 for v in got.values()), got
        assert all(res["metrics"][m]["unit"] == "s" for m in STAGES)
