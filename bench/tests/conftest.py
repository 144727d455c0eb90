import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(kind: str, name: str) -> dict:
    return json.loads((ROOT / "bench" / kind / f"{name}.json").read_text())


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# A cell PERF.md keeps open: its mix and operations are the harness's, and
# its entry waits for a steadier host path. Here it reports what the cell
# named by "like" reports.
OPEN = {"mamba2-1.3b.resume": {"config": "mamba2-1.3b.d8", "traffic": "resume", "chips": 1,
                               "like": "mamba2-1.3b.train_ckpt"}}


def tiny_cell(workload: str, dtype: str = "float32"):
    """(bench, cell, config, traffic, limits) of ``workload`` cut to its
    family's tiny sizes (``TINY`` of ``bench/families/<family>.py``), in
    ``dtype``."""
    from bench.families import family

    bench = bench_json()
    if workload in OPEN:
        spec = OPEN[workload]
        bench["workloads"].append({"name": workload, **{k: spec[k] for k in ("config", "traffic", "chips")}})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if spec["like"] in m.get("workloads", []):
                m["workloads"].append(workload)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load("configs", cell["config"])
    config["model"].update(family(config["family"]).TINY, dtype=dtype)
    if "checkpoint" in config:
        config["cluster"]["chunk_bytes"] = 4096
        config["checkpoint"] = {"target": 4096, "min": 2048, "max": 8192, "mask": 4095}
    traffic = load("traffic", cell["traffic"])
    if "last_steps" not in traffic.get("trace", {}):
        traffic["trace"] = {"first_cycle": 1, "last_cycle": 2}
    return bench, cell, config, traffic, load("limits", cell["config"])


@pytest.fixture
def cpu_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """Skip where there is no CUDA device (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
