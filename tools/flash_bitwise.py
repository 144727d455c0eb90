#!/usr/bin/env python3
"""Hold the flash-attention kernel built from this tree against the one
built from another source tree, bit for bit, at equal head dims.

    python3 tools/flash_bitwise.py --src DIR [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc.
DIR is the root of another checkout, e.g. an unpacked ``git archive`` of
the parent commit in a git-ignored directory. Both trees'
``src/repro_torch/csrc/flash_attn.cu`` are built with the same flags; each
head dim the two share (32, 64, 128, 256, k and v alike) runs float32 and
bfloat16 on five shapes (GQA, causal, windowed, ragged and rectangular),
random from ``--seed``, through both libraries' C entry points. An older
entry point takes one head dim; one that takes v's head dim too
(``hd_v``) is called with it, and one that takes an ``lse`` buffer with a
null one. Where this tree's entry point takes ``lse``, each case runs it
twice, without and with the buffer, and both outputs must equal the other
tree's. It prints one JSON line per case and a verdict, and exits 1 if
any output differs in any bit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (Sq, Skv, H, K, causal, window)
SHAPES = ((700, 700, 40, 8, True, 0), (300, 100, 4, 2, True, 64), (384, 255, 4, 2, False, 0),
          (4097, 4097, 8, 2, True, 0), (100, 100, 8, 2, True, 0))


def build(cu: Path, out: Path) -> tuple[ctypes.CDLL, bool, bool]:
    """The library of ``cu``, whether its entry point takes ``hd_v`` and
    whether it takes ``lse``."""
    from repro_torch.kernels import _build

    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(cu)], check=True, capture_output=True)
    text = cu.read_text()
    two, has_lse = "int64_t hd_v" in text, "void* o, float* lse" in text
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int64
    dims = [i, i] if two else [i]
    lib.flash_attn_launch.argtypes = [p, p, p, p, *([p] if has_lse else []), i, i, i, i, i, *dims,
                                      ctypes.POINTER(i), ctypes.c_float, ctypes.c_int, i, ctypes.c_int, p]
    lib.flash_attn_launch.restype = ctypes.c_int
    return lib, two, has_lse


def run(lib: ctypes.CDLL, two: bool, has_lse: bool, q, k, v, causal: bool, window: int, with_lse: bool = False):
    import torch

    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    dims = [hd, hd] if two else [hd]
    lse_arg = [0 if lse is None else lse.data_ptr()] if has_lse else []
    err = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse_arg, b, sq,
                                k.shape[1], h, k.shape[2], *dims, strides, 1.0 / math.sqrt(hd), int(causal), window,
                                1 if q.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_launch: CUDA error {err}")
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bitwise: torch sees no CUDA device", file=sys.stderr)
        return 2
    rel = Path("src/repro_torch/csrc/flash_attn.cu")
    with tempfile.TemporaryDirectory() as tmp:
        here, *here_kw = build(ROOT / rel, Path(tmp) / "here.so")
        other, *other_kw = build(args.src / rel, Path(tmp) / "other.so")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        same = []
        for hd in (32, 64, 128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                for sq, skv, h, kh, causal, window in SHAPES:
                    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                               for shape in ((1, sq, h, hd), (1, skv, kh, hd), (1, skv, kh, hd)))
                    exp = run(other, *other_kw, q, k, v, causal, window)
                    equal = torch.equal(run(here, *here_kw, q, k, v, causal, window), exp)
                    rec = {"hd": hd, "dtype": str(dtype).removeprefix("torch."), "sq": sq, "skv": skv,
                           "heads": [h, kh], "causal": causal, "window": window, "bitwise_equal": equal}
                    if here_kw[1]:
                        rec["bitwise_equal_with_lse"] = torch.equal(
                            run(here, *here_kw, q, k, v, causal, window, with_lse=True), exp)
                        equal = equal and rec["bitwise_equal_with_lse"]
                    same.append(equal)
                    print(json.dumps(rec))
    print(json.dumps({"ok": all(same), "cases": len(same), "equal": sum(same),
                      "with_lse": bool(here_kw[1])}))
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
