"""The port's copy of the host cluster held against ``repro.core``, and the
port's import boundary.

The cluster modules are host Python plus numpy; the port keeps its own copy
so that it imports nothing of the JAX package. The same seeded operations
through both copies must leave the same counters, savings and fingerprints.
"""

import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as jcore
import repro_torch.core as tcore

REPO = Path(__file__).resolve().parents[1]


def _fp(f) -> tuple[str, bytes]:
    return f.namespace, f.value


def _quickstart(core) -> tuple[dict, float, list]:
    """examples/quickstart.py's cluster steps 1-4 on seeded bytes."""
    rng = np.random.default_rng(0)
    blob = rng.bytes(1 << 20)
    cluster = core.DedupCluster.create(4, replicas=2, chunking=core.ChunkingSpec("fixed", 64 * 1024))
    fps = [
        cluster.write_object("vm-image-a", blob),
        cluster.write_object("vm-image-b", blob),
        cluster.write_object("vm-image-c", blob + rng.bytes(1 << 18)),
    ]
    cluster.tick(2)
    assert cluster.read_object("vm-image-b") == blob
    cluster.crash_node("oss1")
    assert cluster.read_object("vm-image-a") == blob
    cluster.restart_node("oss1")
    cluster.add_node()
    assert cluster.read_object("vm-image-c")[: 1 << 20] == blob
    return cluster.stats.snapshot(), cluster.space_savings(), [_fp(f) for f in fps]


def test_quickstart_cluster_matches_reference():
    got = _quickstart(tcore)
    exp = _quickstart(jcore)
    assert got[0] == exp[0]
    assert got[1] == exp[1]
    assert got[2] == exp[2]


@pytest.mark.parametrize(
    "spec",
    [("fixed", 4096, 0, 0), ("cdc", 1024, 0, 0), ("cdc", 2048, 100, 9000)],
)
def test_chunk_object_matches_reference(spec):
    data = np.random.default_rng(3).bytes(50_000)
    got = tcore.chunk_object(data, tcore.ChunkingSpec(*spec))
    assert got == jcore.chunk_object(data, jcore.ChunkingSpec(*spec))
    assert [_fp(f) for f in tcore.fingerprint_many(got)] == [
        _fp(f) for f in jcore.fingerprint_many(got)
    ]


def test_chunk_specs_match_reference():
    from repro.core.chunking import GEAR_TABLE as J_GEAR
    from repro.core.chunking import ChunkSpec as JSpec
    from repro_torch.core.chunking import GEAR_TABLE as T_GEAR
    from repro_torch.core.chunking import ChunkSpec as TSpec

    assert T_GEAR == J_GEAR
    for target in (512 * 1024, 4096, 1000):
        for kw in ({}, {"min_bytes": 100, "max_bytes": 9000}, {"device": False}):
            assert asdict(TSpec.for_checkpoint(target, **kw)) == asdict(JSpec.for_checkpoint(target, **kw))
        for kw in ({}, {"min_bytes": 100, "max_bytes": 9000}):
            assert TSpec.cdc(target, **kw).kernel_kwargs() == JSpec.cdc(target, **kw).kernel_kwargs()


def test_batched_writes_and_delete_match_reference():
    rng = np.random.default_rng(11)
    items = [(f"obj{i}", rng.bytes(20_000 + 997 * i)) for i in range(6)]
    items.append(("dup", items[2][1]))

    def run(core):
        c = core.DedupCluster.create(3, replicas=2, chunking=core.ChunkingSpec("cdc", 4096))
        fps = c.write_objects(items)
        c.tick(2)
        blobs = c.read_objects([n for n, _ in items])
        c.delete_object("obj1")
        c.run_gc()
        return [_fp(f) for f in fps], blobs, c.stats.snapshot(), c.unique_bytes_stored()

    got, exp = run(tcore), run(jcore)
    assert got == exp
    assert got[1] == [d for _, d in items]


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys, repro_torch, repro_torch.checkpoint, repro_torch.core, chip_smoke\n"
        "import repro_torch.configs, repro_torch.models.convert, repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attn\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
