"""The port's examples (``python -m repro_torch.examples.<name>``) held
against the JAX package's ``examples/``, on the CPU.

Each test runs the reference example and its port in one process
(``runpy``), with ``os.urandom`` replaced by the same seeded bytes for both
and the port given ``--device cpu``, then compares what they print. Each
package draws its own random weights, so only lines that depend on weight
values may differ: none in ``failure_recovery`` and ``quickstart``, the
losses in ``train_e2e``, the KV store's unique bytes in
``serve_prefix_cache``.
"""

import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")

# Everything the examples import, imported before any run: a first import
# may draw from os.urandom, which the runs replace.
import repro.checkpoint  # noqa: E402,F401
import repro.core.placement  # noqa: E402,F401
import repro.data  # noqa: E402,F401
import repro.models  # noqa: E402,F401
import repro.serving  # noqa: E402,F401
import repro.train  # noqa: E402,F401
import repro_torch.checkpoint  # noqa: E402,F401
import repro_torch.core.placement  # noqa: E402,F401
import repro_torch.data  # noqa: E402,F401
import repro_torch.models.convert  # noqa: E402,F401
import repro_torch.serving  # noqa: E402,F401
import repro_torch.train  # noqa: E402,F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run(name: str, argv: list[str], port: bool, capsys, monkeypatch) -> list[str]:
    """The lines one example prints, run with seeded ``os.urandom``."""
    rng = np.random.default_rng(7)
    monkeypatch.setattr(os, "urandom", lambda n: rng.bytes(n))
    monkeypatch.setattr(sys, "argv", [name, *argv, *(["--device", "cpu"] if port else [])])
    capsys.readouterr()
    if port:
        runpy.run_module(f"repro_torch.examples.{name}", run_name="__main__")
    else:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def _both(name: str, capsys, monkeypatch, argv: list[str] = ()) -> tuple[list[str], list[str]]:
    want = _run(name, list(argv), False, capsys, monkeypatch)
    got = _run(name, list(argv), True, capsys, monkeypatch)
    assert got[-1] == want[-1] == f"{name} OK"
    return want, got


def test_failure_recovery_prints_the_reference_lines(capsys, monkeypatch):
    want, got = _both("failure_recovery", capsys, monkeypatch)
    assert got == want
    assert len(got) == 10


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    """The cluster lines (logical and unique bytes, savings, rebalance
    moves) and the checkpoint's ref-only leaf count: the port saves the JAX
    package's parameter tree (``params_tree``), leaf for leaf."""
    want, got = _both("quickstart", capsys, monkeypatch)
    assert got == want
    assert re.fullmatch(r"ckpt ref-only leaves  : \d+ .*", got[-2]), got


def test_serve_prefix_cache_prints_the_reference_table(capsys, monkeypatch):
    """The request table, hit rate, reused and recomputed tokens, and the
    request after a node crash; the KV store's bytes hold weight-dependent
    values, so only its line's shape is compared."""
    want, got = _both("serve_prefix_cache", capsys, monkeypatch)
    assert len(got) == len(want)
    kv = [i for i, line in enumerate(want) if line.startswith("KV store unique MB")]
    assert len(kv) == 1
    assert [line for i, line in enumerate(got) if i not in kv] == [line for i, line in enumerate(want) if i not in kv]
    assert re.fullmatch(r"KV store unique MB  : \d+\.\d\d \(logical \d+\.\d\d\)", got[kv[0]])
    assert got[1:9] == [f"  {i:4d}  |  {0 if i == 0 else 48:4d}  |   {64 if i == 0 else 16:4d}" for i in range(8)]


def test_train_e2e_keeps_the_reference_checkpoint_traffic(capsys, monkeypatch):
    """At a small size: the same lines up to the losses, the same
    checkpoints, and the same checkpoint stats (leaves written, ref-only,
    bytes sent, launches)."""
    argv = ["--dim", "64", "--layers", "2", "--vocab", "256", "--steps", "4", "--seq", "16", "--batch", "2",
            "--ckpt-every", "2"]
    want, got = _both("train_e2e", capsys, monkeypatch, argv)
    mask = lambda lines: [re.sub(r"loss \d+\.\d+", "loss #", line) for line in lines]
    assert mask(got) == mask(want)
    assert "final ckpts: ['step-2', 'step-4']" in got
    stats = next(line for line in got if line.startswith("ckpt stats: "))
    assert re.search(r"'leaves_written': \d+, 'leaves_ref_only': \d+", stats)
