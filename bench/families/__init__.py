"""Model families, one file each: ``bench/families/<family>.py``, found by a
configuration's ``family`` as metric readers are found by their name.

A family file defines:
  layout(m)              (key path, shape, kind, scale) of every leaf of the
                         weights, in the order ``bench.weights`` draws them;
  loss(params, m, batch) the plain float32 reference's mean next-token loss
                         on a microbatch, its products as ``models.matmul``
                         (looked up at call time, so the control's swap
                         reaches them);
  model_flop_per_step(m) the model FLOPs of one training step;
  TINY                   the sizes the CPU tests run it at;
  WIDTHS                 the ``model`` keys a configuration may never list
                         as reduced.
A configuration of a new family is its file here, its configuration and
limits files and its entries in ``BENCHMARK.json``; nothing else changes.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAMES = ("layout", "loss", "model_flop_per_step", "TINY", "WIDTHS")


def family(name: str):
    """The module ``bench/families/<name>.py``."""
    return _load(HERE / f"{name}.py")


@functools.cache
def _load(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no model family file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_family_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
