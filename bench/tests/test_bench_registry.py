"""BENCHMARK.json finds every configuration, mix, limit and metric reader by
name, and keeps to the benchmark's contract for names, units and cells."""

import importlib.util
import json
import re

from conftest import ROOT, bench_json, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_config_mix_and_limits_by_name():
    bench = bench_json()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        assert (ROOT / cfg["file"]).is_file()
        assert load("configs", w["config"])["name"] == w["config"]
        assert load("traffic", w["traffic"])["name"] == w["traffic"]
        limits = load("limits", w["config"])
        assert {"loss_gap", "grad_norm_gap", "grad_leaf_gap", "change_leaf_gap"} <= set(limits)
        assert w["chips"] == 1


def test_every_metric_has_a_reader_file():
    bench = bench_json()
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = ROOT / "bench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read), m["name"]


def test_names_units_and_cells_keep_to_the_contract():
    bench = bench_json()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        # each cell that reports the metric reports what it moves
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in layer and "\t" not in layer for layer in layers)


def test_every_config_finds_its_family_file():
    """Each configuration's ``family`` is a file under ``bench/families/``
    that defines the names the harness reads."""
    from bench.families import NAMES, family

    for c in bench_json()["configs"]:
        fam = family(load("configs", c["name"])["family"])
        assert all(hasattr(fam, name) for name in NAMES), (c["name"], fam.__file__)
        assert callable(fam.layout) and callable(fam.loss) and callable(fam.model_flop_per_step)


def test_each_config_keeps_its_source_but_for_what_it_lists_as_reduced():
    """Every size the file states as published is the one run, unless the
    file and BENCHMARK.json both list it as reduced; no width is reduced,
    of any family file's ``WIDTHS``."""
    from bench.families import HERE, family

    widths = set().union(*(family(path.stem).WIDTHS for path in HERE.glob("*.py") if path.stem != "__init__"))
    for c in bench_json()["configs"]:
        cfg = load("configs", c["name"])
        assert set(cfg["reduced"]) == set(c["reduced"]), c["name"]
        for key, value in cfg["published"].items():
            want = cfg["reduced"].get(key, value)
            assert cfg["model"][key] == want, (c["name"], key)
        assert not widths & set(cfg["reduced"]), c["name"]


def test_recorded_readings_are_judged_as_the_limits_say():
    """The chip readings each limit was set from (``bench.control --out``):
    under the committed limits every program reading is correct, and every
    control and planted-fault reading is not. A state left unchanged reads
    1 on the change gaps, so each of those limits is under 1."""
    from bench.check import judge

    for c in bench_json()["configs"]:
        limits = load("limits", c["name"])
        path = ROOT / "bench" / "limits" / f"{c['name']}.readings.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
        kinds = {r["kind"] for r in rows}
        assert {"program", "control float8", "fault half batch"} <= kinds, c["name"]
        assert len({r["seed"] for r in rows if r["kind"] == "program"}) >= 6, c["name"]
        for r in rows:
            numbers = {k: v for k, v in r.items() if k not in ("seed", "kind", "correct")}
            ok, _ = judge(numbers, limits)
            assert ok == (r["kind"] == "program"), (c["name"], r["seed"], r["kind"])
        assert limits["change_leaf_gap"] < 1 and limits["change_median_gap"] < 1
