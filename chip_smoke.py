#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU: the dedup checkpoint
save, training with dedup checkpoints at the full width of
LLaVA-NeXT-Mistral-7B, Qwen2.5-32B prefill and prefix-cache serving at
full width, and the sliding-window families (Gemma3-12B, RecurrentGemma-2B)
at full width.

    python3 chip_smoke.py [--seed 0]

Run from the root of the repository on a machine with a CUDA card and nvcc.
float32 products run in full float32 (TF32 is switched off for matmuls and
cuDNN). Phases, each of which raises (exit code 1) on any failure:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and print the build seconds; read the fingerprint
   kernel's integer operations per word from its SASS (``cuobjdump``);
2. hold each dedup kernel against its plain torch twin on the card, at exact
   equality, on its own test shapes (the window hashes also on a stream
   longer than 2^31 bytes, around position 2^31 and at its end, freed
   before phase 3); the seed-15 bench wave must give the
   pinned n_chunks / boundary_checksum (24/956437 at 0.25 MiB, 201/71402112
   at 2 MiB), and its cut positions and masks must equal the twin's;
3. the checkpoint path at full size: one decoder layer of Qwen2.5-32B at
   full width in bf16 (~975 MB, random from ``--seed``) saved, re-saved,
   perturbed and saved again, then restored, through ``DedupCheckpointer``
   on a 4-node, 2-replica cluster with 512 KiB fixed chunks; the largest
   leaf's device cuts are held against ``chunk_cdc(backend="kernel")`` and
   the host numpy chunker. Every kernel count is set to 0 just before this
   phase and read just after;
4. time each dedup kernel and its plain twin at that path's shapes and
   compare the cut positions and the whole fingerprint block with the
   twin; split the cut kernel's time into its two phases and take the
   window-hash kernel's device time (``torch.profiler``);
   hold the cut kernel against the twin on ``bitmap_route_wave`` too, so
   both of its routes run (the main path takes only the list route);
4b. the train path at full width: LLaVA-NeXT-Mistral-7B's backbone from
   the port's registry, 2 of its 32 layers, bf16, ``attn_impl="dense"``,
   ``remat="full"``, random weights from ``--seed``; shape ``train_4k``
   (576 bf16 patch embeddings + 3,520 text tokens from
   ``SyntheticLMData``), global batch 2 in 2 microbatches, AdamW; the state
   (9.78 GB, 49 leaves) checkpointed by ``train_loop``'s hook through
   ``DedupCheckpointer`` on ``DedupCluster.create(4, replicas=2,
   chunking=ChunkingSpec("fixed", 256 KiB))``. ``examples/train_e2e.py``'s
   traffic (``train_traffic``): steps 0-1 saving step-2, a node crash,
   ``add_node`` and ``scrub``, a restore of step-2 (bitwise against the
   live state, the same loss on step 2's batch), an identical re-save
   (all ref-only, 0 B sent), steps 2-3 resumed saving step-4. Every save
   makes 1 cut + 1 fingerprint launch; the counts are set to 0 just
   before the traffic and read just after. Then the cut and fingerprint
   kernels are held against their twins on the train state's wave (every
   stream's positions and counts, every fingerprint row) and timed there.
   Everything is freed before phase 5 (``torch.cuda.memory_allocated()``
   back to its level);
5. hold the flash-attention kernel against its plain version on the card:
   the (causal, window) x (H, K) grid, (40, 8) heads at hd 128, float32 and
   bfloat16, Sq != Skv and ragged lengths, counting the elements beyond
   tolerance (``FLASH_RTOL``: relative to each element and to its row's RMS),
   a count phases 6 and 8 add to;
6. the prefill path at full width: Qwen2.5-32B from the port's registry
   with ``attn_impl="chunked"``, all 64 layers, bf16, random weights from
   ``--seed`` on the card (65.5 GB); prefill 1 x 8,192 tokens into a
   8,200-slot cache, then decode 8 tokens. The counts are set to 0 just
   before the prefill and read after it (64 flash launches) and after the
   decode (0 more). Layer 0's attention at that shape is held against the
   plain version and timed beside it and beside PyTorch's
   ``scaled_dot_product_attention`` (timed only). The bf16 kernel,
   ``flash_fwd_wgmma``, must be among the prefill profile's five largest
   kernels, take at most twice SDPA's time, and spill no registers at any
   of its four head dims, nor may ``flash_fwd_simt<float, 256>`` (their
   registers from ``cuobjdump -res-usage``, its TFLOP/s and its nvcc
   seconds, null when the library was already built, go into its row);
7. the serving path at full width: ``BatchedServer`` on the same model over
   ``DedupCluster.create(4, chunking=ChunkingSpec("fixed", 64 KiB))`` with
   ``repro_torch.launch.serve``'s traffic (48 shared prefix tokens, 8 random
   ones, 8 generated, blocks of 8 tokens, 4 requests), then request 0's
   prompt again, which must give the same tokens. Then Qwen2.5-32B is freed;
8. the sliding-window families at full width, all layers, bf16,
   ``attn_impl="chunked"``, random weights from ``--seed``, each alone on
   the card: Gemma3-12B (48 layers, 5 local with window 1024 : 1 global,
   16 / 8 heads x 256; 11.77 B parameters) and RecurrentGemma-2B (26
   layers, (rglru, rglru, local with window 2048) x 8 + 2 rglru, 10 / 1
   heads x 256). ``family_traffic``: prefill 1 x 8,192 tokens into
   8,200-slot caches (the local layers' rings wrap 8 or 4 times), 8
   teacher-forced decode steps; the counts are set to 0 just before the
   prefill, which must launch the flash kernel once per attention layer
   (48, 40 of them windowed; 8, all windowed), and the decode none; the
   last decode step's logits must be within 0.05 (relative max error) of
   a fresh prefill of all 8,200 tokens. Then the flash kernel at the
   model's attention shapes (hd 256), with and without the window, bf16
   and float32, is held against the plain version and timed beside it and
   beside ``scaled_dot_product_attention``. Each model's phase must leave
   nothing allocated on the card.

It prints ``main_path``, ``train``, ``prefill``, ``serving`` and ``family``
JSON lines, a ``kernels`` JSON line, the card's name and power limit from nvidia-smi, and
last ``{"ok": true, "device": ...}``. It exits non-zero without printing a
result when torch sees no CUDA device or the repository's package is not
beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Qwen2.5-32B (src/repro/configs/qwen2_5_32b.py): dense GQA with QKV bias.
QWEN2_5_32B = dict(d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648, qkv_bias=True)

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# operations/s at instruction issue: 132 SMs x 4 schedulers x 32 lanes at the
# 1.98 GHz boost clock. The 64 INT32 units per SM are no floor on their own:
# integer multiply-adds and adds also issue to the 128 FP32/FMA lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations the CDC kernels need per byte (see the csrc notes): cut
# positions: gear lookup, shift-add, mask, compare; window hashes: gear
# lookup, shift-add. Both kernels are bound by bytes, far from these. The
# fingerprint's count per word is read from the built kernel's SASS
# (``sass_ops_per_word``); counted from the source it is 44: 4 lanes x
# (2 multiply-adds + 8 fmix32 steps + 1 accumulate).
CUT_OPS_PER_BYTE = 4
HASH_OPS_PER_BYTE = 2
# bf16 tensor-core peak (dense) of an H100 SXM at its 700 W limit.
BF16_FLOP_PER_S = 989e12
# The flash kernel's tolerance: |kernel - plain| <= rtol * (|plain| + the RMS
# of plain's row over the head dim), per element. The limit scales with the
# data: late rows of a long causal prefill average thousands of value rows,
# so their elements are ~0.02 and a fixed floor such as the reference's 3e-2
# flags only a few of the elements a kernel that drops KV tiles there gets
# wrong. bfloat16: 1.6e-2 is two bf16 steps at the bottom of a binade, about
# twice the sound kernel's largest reading (the kernel and the plain version
# round the output apart, and the kernel rounds P to bf16 for the tensor
# cores). tools/flash_planted_faults.py plants dropped tiles in the late
# rows and shows that this check fails them.
FLASH_RTOL = {"float32": 2e-4, "bfloat16": 1.6e-2}
# A window-hash stream longer than 2^31 bytes (2.2 GB in, 8.9 GB out).
LONG_STREAM = (1 << 31) + (1 << 26) + 7
# The train phase: LLaVA-NeXT-Mistral-7B (src/repro/configs/
# llava_next_mistral_7b.py) at full width, depth 32 -> 2, shape train_4k
# (4,096 positions, 576 of them the vision stub's), global batch 256 -> 2.
TRAIN_ARCH = "llava-next-mistral-7b"
TRAIN_LAYERS = 2
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_ACCUM = 2
PREFILL_TOKENS = 8192
PREFILL_CACHE = 8200
DECODE_TOKENS = 8
_INT_ALU = {"IMAD", "VIADD", "IADD3", "IADD", "SHF", "SHL", "SHR", "LOP3", "LEA", "IMUL", "PRMT"}


def sass_ops_per_word(sass: str, func: str) -> tuple[float, float]:
    """Read a kernel's per-word cost from ``cuobjdump -sass`` text.

    ``func``'s inner loop is the span a backward branch closes; each 32-bit
    load in it is one word. Returns (instructions the loop issues per word,
    integer ALU operations per word that follow a word's load up to the end
    of its guarded block, i.e. the arithmetic done on the loaded word)."""
    body = next(f for f in sass.split("Function : ")[1:] if func in f.split("\n", 1)[0])
    ins = []
    for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*);", body):
        parts = text.split()
        if parts[0].startswith("@"):
            parts = parts[1:]
        ins.append((int(addr, 16), parts[0], parts[1:]))
    back = [(int(args[0], 16), a) for a, op, args in ins if op == "BRA" and int(args[0], 16) < a]
    _check(len(back) == 1, f"{func}: {len(back)} backward branches in the SASS, want 1")
    lo, hi = back[0]
    loop = [op for a, op, _ in ins if lo <= a <= hi]
    loads = [i for i, op in enumerate(loop) if op.startswith("LDG")]
    _check(bool(loads), f"{func}: no global load in the SASS loop")
    dependent = 0
    for i in loads:
        for op in loop[i + 1 :]:
            if op == "BSYNC" or op.startswith("LDG"):
                break
            dependent += op.split(".")[0] in _INT_ALU
    return len(loop) / len(loads), dependent / len(loads)


def res_usage(text: str) -> dict[str, dict]:
    """Registers, stack and local (spill) bytes per thread of each kernel in
    ``cuobjdump -res-usage`` text, keyed ``name<hd>`` from the mangled name
    (``flash_fwd_wgmma<128>``)."""
    out = {}
    for fn, reg, stack, local in re.findall(
        r"Function ([^\s:]+):\s*REG:(\d+)\s+STACK:(\d+)\s+SHARED:\d+\s+LOCAL:(\d+)", text
    ):
        name = re.search(r"\d+([a-z_]+)I(?:f)?Li(\d+)E", fn)
        if name:
            out[f"{name.group(1)}<{name.group(2)}>"] = {
                "registers": int(reg), "stack_bytes": int(stack), "local_bytes": int(local),
            }
    return out


def decoder_layer_shapes(
    d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, d_ff: int,
    qkv_bias: bool, n_layers: int = 1,
) -> dict:
    """The parameter tree ``init_decoder`` builds for a dense decoder whose
    block pattern is one global-attention block, as leaf shapes: blocks
    stacked on a leading dim of ``n_layers``, embedding and lm_head left out."""
    L = n_layers

    def dense(d_in: int, d_out: int, bias: bool) -> dict:
        p = {"w": (L, d_in, d_out)}
        if bias:
            p["b"] = (L, d_out)
        return p

    block = {
        "norm1": {"scale": (L, d_model)},
        "attn": {
            "wq": dense(d_model, n_heads * head_dim, qkv_bias),
            "wk": dense(d_model, n_kv_heads * head_dim, qkv_bias),
            "wv": dense(d_model, n_kv_heads * head_dim, qkv_bias),
            "wo": dense(n_heads * head_dim, d_model, False),
        },
        "norm2": {"scale": (L, d_model)},
        "ffn": {
            "gate": dense(d_model, d_ff, False),
            "up": dense(d_model, d_ff, False),
            "down": dense(d_ff, d_model, False),
        },
    }
    return {"blocks": (block,), "final_norm": {"scale": (d_model,)}, "tail": ()}


def materialize(shapes, make):
    """Replace every shape tuple of a shape tree with ``make(shape)``."""
    if isinstance(shapes, dict):
        return {k: materialize(v, make) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and not all(isinstance(d, int) for d in shapes):
        return tuple(materialize(v, make) for v in shapes)
    if isinstance(shapes, tuple) and shapes:
        return make(shapes)
    return ()


def seed15_wave(buf_bytes: int):
    """The seed-15 wave of benchmarks/write_path_bench.py::bench_device_cdc."""
    import numpy as np

    rng = np.random.default_rng(15)
    weights = [8, 4, 2, 1, 1]
    sizes = [max(1, buf_bytes * w // sum(weights)) for w in weights]
    return [rng.integers(0, 256, size=s, dtype=np.uint8) for s in sizes]


def bitmap_route_wave(seed: int, device):
    """A 64 MiB wave of random bytes, cut at a 2 KiB target (1 KiB..8 KiB),
    whose 44 MiB stream holds ~22,500 candidates, more than the cut kernel's
    candidate list (8,192), so it takes the bitmap route; its 12 and 8 MiB
    streams (~6,100 and ~4,100) take the list route. Returns (streams on
    ``device``, the kernel's mask / min_size / max_size)."""
    import numpy as np
    import torch

    from repro_torch.core.chunking import cdc_mask

    rng = np.random.default_rng(seed + 1)
    streams = [torch.from_numpy(rng.integers(0, 256, size=n << 20, dtype=np.uint8)).to(device)
               for n in (44, 12, 8)]
    return streams, dict(mask=cdc_mask(2048), min_size=1024, max_size=8 * 1024)


def cut_bound_ms(wave_bytes: int, m_cut: int, n_streams: int) -> tuple[float, float]:
    """(bytes, operations) lower bounds in ms of one cut-positions call:
    each stream byte read once and the (m_cut,) int32 positions and (S, 3)
    int32 counts written once, over the HBM rate; ``CUT_OPS_PER_BYTE``
    integer operations per byte over the integer peak."""
    nbytes = wave_bytes + 4 * m_cut + 12 * n_streams
    return nbytes / HBM_BYTES_PER_S * 1e3, CUT_OPS_PER_BYTE * wave_bytes / INT32_OPS_PER_S * 1e3


def _timed(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events, warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class TwinCheck:
    """Holds the dedup kernels' outputs against their plain twins, bit for
    bit. Keeps per kernel, over every comparison, the max |kernel - twin|
    (``err``) and the count of elements that differ (``mismatches``)."""

    def __init__(self):
        self.err = {"fingerprint": 0, "cdc_cut": 0, "cdc_hash": 0}
        self.mismatches = dict.fromkeys(self.err, 0)

    def compare(self, kind: str, a, b, what: str) -> None:
        """Hold a kernel's output ``a`` against its twin's ``b``, bit for bit."""
        import torch

        _check(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        a64, b64 = a.to(torch.int64), b.to(torch.int64)
        if a.dtype == torch.int32:
            a64, b64 = a64 & 0xFFFFFFFF, b64 & 0xFFFFFFFF
        diff = (a64 - b64).abs()
        n_diff = int((diff != 0).sum())
        self.err[kind] = max(self.err[kind], int(diff.max()) if diff.numel() else 0)
        self.mismatches[kind] += n_diff
        _check(n_diff == 0, f"{what}: {n_diff} elements differ from the twin")

    def cuts(self, streams: list, kw: dict, what: str) -> tuple[list, float]:
        """Hold the cut kernel's positions and counts on the whole wave
        against the twin's, which runs stream by stream (its int64
        intermediates are 8 B a byte). Returns the kernel's result and the
        twin's ms (host clock, summed over the streams)."""
        import torch

        from repro_torch.kernels.cdc import cdc_cut_positions_cuda, cdc_cut_positions_plain

        got = cdc_cut_positions_cuda(streams, **kw)
        plain_ms = 0.0
        for i, (s, (g, gn, gk)) in enumerate(zip(streams, got)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e, en, ek = cdc_cut_positions_plain([s], **kw)[0]
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t) * 1e3
            self.mismatches["cdc_cut"] += int(gn != en) + int(gk != ek)
            _check((gn, gk) == (en, ek), f"{what}, stream {i}: n_cuts, n_chunks {(gn, gk)} != {(en, ek)}")
            self.compare("cdc_cut", g, e, f"{what}, stream {i}")
        return got, plain_ms

    def fingerprints(self, rows, fps, what: str) -> float:
        """Hold the fingerprint kernel's ``fps`` of ``rows`` against the
        twin's, over blocks of 64 rows (the twin's (C, W, 4) int64
        intermediate of a whole wave does not fit at once), which cover
        every row. Returns the twin's ms (host clock)."""
        import torch

        from repro_torch.kernels.fingerprint import fingerprint_chunks_plain

        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(0, rows.shape[0], 64):
            self.compare("fingerprint", fps[i : i + 64], fingerprint_chunks_plain(rows[i : i + 64]),
                         f"{what}, rows {i}..{i + 63}")
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3


def fp_bound_ms(c_rows: int, width: int, ops_per_word: float) -> tuple[float, float]:
    """(bytes, operations) lower bounds in ms of one fingerprint call on
    (c_rows, width) uint32 rows: the rows read once and the (c_rows, 4)
    uint32 written once over the HBM rate; ``ops_per_word`` integer
    operations per word over the integer peak."""
    nbytes = c_rows * width * 4 + c_rows * 16
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_per_word * c_rows * width / INT32_OPS_PER_S * 1e3


def dedup_phases(seed: int, fp_ops_per_word: float, fp_issued_per_word: float) -> list[dict]:
    """Phases 2-4, the checkpoint path. Prints the ``main_path`` line and
    returns the dedup kernels' rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
    from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.core.chunking import _cdc_candidates, _cdc_cuts, cdc_mask, chunk_cdc
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc import (
        cdc_cut_masks_cuda,
        cdc_cut_masks_plain,
        cdc_cut_positions_cuda,
        cdc_hashes_cuda,
        cdc_hashes_plain,
    )
    from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda, fingerprint_chunks_plain

    dev = torch.device("cuda")
    kernels = (fingerprint_chunks_cuda, cdc_cut_positions_cuda, cdc_hashes_cuda)
    routes = cdc_cut_positions_cuda.routes
    for route in routes:
        routes[route] = 0

    # Per kernel, over every comparison with its twin in phases 2 and 4: the
    # max |kernel - twin| and the count of elements that differ.
    check = TwinCheck()
    err, mismatches, compare, compare_cuts = check.err, check.mismatches, check.compare, check.cuts

    # ----------------------------------------- 2. kernels vs twins, exact
    gen = np.random.default_rng(seed)
    for shape in [(1, 128), (2, 129), (5, 511), (8, 512), (13, 1000), (256, 512), (300, 700),
                  (257, 513), (70, 600), (64, 262272)]:
        x = torch.from_numpy(gen.integers(0, 2**32, size=shape, dtype=np.uint32)).to(dev)
        compare("fingerprint", fingerprint_chunks_cuda(x), fingerprint_chunks_plain(x),
                f"fingerprint kernel at {shape}")
    for n in (33, 5000, 1 << 24):
        data = torch.from_numpy(gen.integers(0, 256, size=n, dtype=np.uint8)).to(dev)
        compare("cdc_hash", cdc_hashes_cuda(data), cdc_hashes_plain(data), f"window-hash kernel at n={n}")
    # A stream longer than 2^31 bytes: the windows around 2^31 and the last
    # 64, each against the plain hash of the 32 bytes before it and itself.
    n = LONG_STREAM
    data = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))
    got = cdc_hashes_cuda(data)
    for lo, hi in (((1 << 31) - 64, (1 << 31) + 64), (n - 64, n)):
        compare("cdc_hash", got[lo:hi], cdc_hashes_plain(data[lo - 32 : hi])[32:],
                f"window-hash kernel at positions [{lo}, {hi}) of a {n}-byte stream")
    del data, got
    torch.cuda.empty_cache()
    wave_kw = dict(mask=cdc_mask(8 * 1024), min_size=4 * 1024, max_size=16 * 1024)
    for buf, pinned in ((256 * 1024, (24, 956437)), (2 * 1024 * 1024, (201, 71402112))):
        streams = [torch.from_numpy(s).to(dev) for s in seed15_wave(buf)]
        for g, p in zip(cdc_cut_masks_cuda(streams, **wave_kw), cdc_cut_masks_plain(streams, **wave_kw)):
            compare("cdc_cut", g, p, f"cut-mask kernel on the seed-15 wave at {buf} B")
        compare_cuts(streams, wave_kw, f"cut-positions kernel on the seed-15 wave at {buf} B")
        res = ops.cdc_cut_and_fingerprint_many(streams, **wave_kw)
        n_chunks = sum(r[3] for r in res)
        checksum = sum(int(r[0][: r[1]].to(torch.int64).sum()) for r in res) % (1 << 32)
        print(f"seed-15 wave {buf} B: n_chunks={n_chunks} boundary_checksum={checksum}")
        _check((n_chunks, checksum) == pinned, f"seed-15 wave at {buf} B: want {pinned}")
    torch.cuda.synchronize()
    print("kernels vs twins: " + json.dumps({"max_abs_err": err, "mismatches": mismatches}))

    # ------------------------------------------------ 3. main path, full size
    cuda_gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = decoder_layer_shapes(**QWEN2_5_32B)
    tree = materialize(
        shapes, lambda s: torch.randn(s, generator=cuda_gen, device=dev, dtype=torch.bfloat16)
    )
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 512 * 1024))
    ckpt = DedupCheckpointer(cluster, CheckpointConfig())
    spec = ckpt.spec
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    routes_before = dict(routes)

    def save(name: str) -> tuple[dict, float, dict, dict]:
        ops_before = ops.launch_snapshot()
        k_before = [k.launches for k in kernels]
        t = time.perf_counter()
        manifest = ckpt.save(name, tree)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        ops_d = {kind: ops.launch_counts[kind] - ops_before[kind] for kind in ops_before}
        k_d = {k.__name__: k.launches - b for k, b in zip(kernels, k_before)}
        return manifest, dt, ops_d, k_d

    n_leaves = 13
    m1, t_s1, _, _ = save("s1")
    _check(len(m1["leaves"]) == n_leaves, f"{len(m1['leaves'])} leaves, want {n_leaves}")
    _check(not any(e["ref"] for e in m1["leaves"]), "s1 must write every leaf")
    sent_s1 = ckpt.stats["bytes_sent"]
    m2, t_s2, ops_d2, k_d2 = save("s2")
    _check(all(e["ref"] for e in m2["leaves"]), "s2 of the same tree must be ref-only")
    _check(ops_d2 == {"cdc": 1, "fingerprint": 1, "flash": 0}, f"s2 launches {ops_d2}")
    _check(k_d2["cdc_cut_positions_cuda"] == 1 and k_d2["fingerprint_chunks_cuda"] == 1, f"s2 kernels {k_d2}")
    ffn = tree["blocks"][0]["ffn"]
    for leaf in (ffn["gate"]["w"], ffn["up"]["w"], ffn["down"]["w"]):
        flat = leaf.view(-1)
        idx = torch.randint(0, flat.numel(), (16,), generator=cuda_gen, device=dev)
        flat[idx] += 1.0
    m3, t_s3, ops_d3, _ = save("s3")
    written = sorted(e["key"] for e in m3["leaves"] if not e["ref"])
    _check(len(written) == 3 and all("['ffn']" in k for k in written), f"s3 wrote {written}")
    _check(sum(e["ref"] for e in m3["leaves"]) == n_leaves - 3, "s3 must ref 10 leaves")
    t = time.perf_counter()
    back = ckpt.restore("s3", like=tree)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t
    flat_tree = _leaf_paths(tree)
    flat_back = _leaf_paths(back)
    _check([k for k, _ in flat_tree] == [k for k, _ in flat_back], "restore changed the tree's keys")
    for (key, a), (_, b) in zip(flat_tree, flat_back):
        _check(b.device.type == "cuda" and torch.equal(a.view(torch.int16), b.view(torch.int16)),
               f"restore of {key} is not bitwise equal")
    # The largest leaf: fused device cuts == chunk_cdc(backend="kernel") ==
    # the host numpy chunker.
    big_key, big = max(flat_tree, key=lambda kv: kv[1].numel())
    stream = ops.tensor_to_u8(big)
    cutpos, n_cuts, _, _ = ops.cdc_cut_and_fingerprint(stream, spec=spec)
    dev_cuts = cutpos[:n_cuts].cpu().numpy().astype(np.int64)
    data = stream.cpu().numpy().tobytes()
    host_cuts = np.asarray(_cdc_cuts(_cdc_candidates(data, spec.mask), len(data), spec.min_bytes, spec.max_bytes))
    _check(np.array_equal(dev_cuts, host_cuts), f"{big_key}: device cuts != host numpy cuts")
    kernel_chunks = chunk_cdc(data, spec.to_chunking(), backend="kernel")
    kernel_ends = np.cumsum([len(c) for c in kernel_chunks]) - 1
    _check(np.array_equal(np.union1d(dev_cuts, [len(data) - 1]), kernel_ends),
           f"{big_key}: device cuts != chunk_cdc(backend='kernel')")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    routes_main = {r: n - routes_before[r] for r, n in routes.items()}
    for name, n in launches.items():
        _check(n > 0, f"{name} was never launched on the main path")
    print(f"largest leaf {big_key}: {len(data)} B, {int(n_cuts)} cuts equal on device, kernel route and host")

    # --------------------------------------- 4. times at the main path's shapes
    streams = [ops.tensor_to_u8(a) for _, a in flat_tree]
    kw = spec.kernel_kwargs()
    t = time.perf_counter()
    wave = ops.cdc_cut_and_fingerprint_many(streams, spec=spec)
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t
    n_chunks = sum(r[3] for r in wave)
    del wave
    wave_bytes = sum(int(s.numel()) for s in streams)
    t = time.perf_counter()
    rows, _ = ops.cut_wave_rows(streams, **kw)
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t
    fps = fingerprint_chunks_cuda(rows)
    fp_plain_ms = check.fingerprints(rows, fps, "fingerprint kernel on the main-path wave")
    fp_ms = _timed(lambda: fingerprint_chunks_cuda(rows), 5)
    c_rows, width = rows.shape
    fp_bound_bytes, fp_bound_ops = fp_bound_ms(c_rows, width, fp_ops_per_word)
    del rows, fps

    cut_ms = _timed(lambda: cdc_cut_positions_cuda(streams, **kw), 5)
    cuts, cut_plain_ms = compare_cuts(streams, kw, "cut-positions kernel on the main-path wave")
    m_cut = sum(int(p.numel()) for p, _, _ in cuts)
    cut_profile = profile_calls(lambda: cdc_cut_positions_cuda(streams, **kw), 5)
    cut_phase_ms = {"A": device_ms_of(cut_profile, "cdc_phase_a"), "B": device_ms_of(cut_profile, "cdc_phase_b")}
    cut_bound_bytes, cut_bound_ops = cut_bound_ms(wave_bytes, m_cut, len(streams))
    # PR 11's bound charged a bool mask as large as the wave as the output.
    cut_bound_prev = max(2 * wave_bytes / HBM_BYTES_PER_S * 1e3, cut_bound_ops)
    bitmap_streams, bitmap_kw = bitmap_route_wave(seed, dev)
    compare_cuts(bitmap_streams, bitmap_kw, "cut-positions kernel on the bitmap-route wave")
    bitmap_ms = _timed(lambda: cdc_cut_positions_cuda(bitmap_streams, **bitmap_kw), 5)
    del bitmap_streams
    _check(all(n > 0 for n in routes.values()), f"the cut kernel's routes over the run: {routes}")

    hash_ms = _timed(lambda: cdc_hashes_cuda(stream), 5)
    hash_device_ms = device_ms_of(profile_calls(lambda: cdc_hashes_cuda(stream), 5), "cdc_hashes")
    t = time.perf_counter()
    hash_plain = cdc_hashes_plain(stream)
    torch.cuda.synchronize()
    hash_plain_ms = (time.perf_counter() - t) * 1e3
    compare("cdc_hash", cdc_hashes_cuda(stream), hash_plain, "window-hash kernel on the largest leaf")
    del hash_plain
    n_big = int(stream.numel())
    hash_bound_bytes = 5 * n_big / HBM_BYTES_PER_S * 1e3
    hash_bound_ops = HASH_OPS_PER_BYTE * n_big / INT32_OPS_PER_S * 1e3

    main = {
        "tree": "Qwen2.5-32B decoder layer, bf16, n_layers 1, no embed/lm_head",
        "leaves": n_leaves,
        "tree_bytes": wave_bytes,
        "fp_rows": c_rows,
        "chunks": n_chunks,
        "fp_row_words": width,
        "save_s": {"s1": t_s1, "s2": t_s2, "s3": t_s3},
        "restore_s": t_restore,
        "device_wave_s": t_wave,
        "cut_and_rows_s": t_rows,
        "bytes_sent": {"s1": sent_s1, "total": ckpt.stats["bytes_sent"]},
        "leaves_ref_only": ckpt.stats["leaves_ref_only"],
        "launches_per_save": {"s2": ops_d2, "s3": ops_d3},
        "kernel_launches": launches,
        "cut_routes": routes_main,
    }
    print("main_path " + json.dumps(main))
    rows_out = [
        {
            "name": "cdc_cut_positions_cuda", "route": "cuda", "source": "src/repro_torch/csrc/cdc.cu",
            "replaces": "src/repro/kernels/cdc.py:112", "launches": launches["cdc_cut_positions_cuda"],
            "mismatches": mismatches["cdc_cut"], "max_abs_err": err["cdc_cut"], "ms": cut_ms, "plain_ms": cut_plain_ms,
            "bound_ms": max(cut_bound_bytes, cut_bound_ops),
            "bound_by": "bytes" if cut_bound_bytes >= cut_bound_ops else "operations",
            "bound_prev_ms": cut_bound_prev, "library_ms": None,
            "phase_ms": cut_phase_ms, "device_ms": cut_profile["device_ms_per_call"],
            "routes": dict(routes), "bitmap_route_wave_ms": bitmap_ms,
            "shape": f"{len(streams)} streams, {wave_bytes} B, {m_cut} cut slots",
        },
        {
            "name": "fingerprint_chunks_cuda", "route": "cuda",
            "source": "src/repro_torch/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:45",
            "launches": launches["fingerprint_chunks_cuda"], "mismatches": mismatches["fingerprint"],
            "max_abs_err": err["fingerprint"], "ms": fp_ms, "plain_ms": fp_plain_ms,
            "bound_ms": max(fp_bound_bytes, fp_bound_ops),
            "bound_by": "bytes" if fp_bound_bytes >= fp_bound_ops else "operations",
            "library_ms": None, "shape": f"({c_rows}, {width}) uint32",
            "int_ops_per_word": fp_ops_per_word, "issued_per_word": fp_issued_per_word,
        },
        {
            "name": "cdc_hashes_cuda", "route": "cuda", "source": "src/repro_torch/csrc/cdc.cu",
            "replaces": "src/repro/kernels/cdc.py:48", "launches": launches["cdc_hashes_cuda"],
            "mismatches": mismatches["cdc_hash"], "max_abs_err": err["cdc_hash"], "ms": hash_ms, "plain_ms": hash_plain_ms,
            "bound_ms": max(hash_bound_bytes, hash_bound_ops),
            "bound_by": "bytes" if hash_bound_bytes >= hash_bound_ops else "operations",
            "library_ms": None, "device_ms": hash_device_ms, "shape": f"({n_big},) uint8",
        },
    ]
    return rows_out


class PatchedLMData:
    """``SyntheticLMData``'s text batches plus the vision stub's patch
    embeddings, drawn in ``dtype`` on ``device`` from a generator seeded by
    (seed, step), so a step's batch can be drawn again."""

    def __init__(self, data, n_front: int, d_model: int, dtype, device, seed: int):
        self.data, self.n_front, self.d_model = data, n_front, d_model
        self.dtype, self.device, self.seed = dtype, device, seed

    def batch(self, step: int) -> dict:
        import torch

        out = dict(self.data.batch(step))
        gen = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + step)
        out["patch_embeds"] = torch.randn((self.data.global_batch, self.n_front, self.d_model),
                                          generator=gen, device=self.device, dtype=self.dtype)
        return out


class TimedSaves:
    """A ``DedupCheckpointer`` whose saves and device waves are timed on the
    host clock between ``sync()`` calls; each save's seconds, wave seconds
    and stats deltas go to ``saves``. The train loop calls ``save``."""

    def __init__(self, ckpt, sync):
        self.ckpt, self.sync, self.saves = ckpt, sync, []
        inner = ckpt._batch_device_fps

        def timed_wave(leaves):
            sync()
            t = time.perf_counter()
            out = inner(leaves)
            sync()
            self._wave_s = time.perf_counter() - t
            return out

        ckpt._batch_device_fps = timed_wave

    def save(self, name: str, tree) -> dict:
        before = dict(self.ckpt.stats)
        self.sync()
        t = time.perf_counter()
        manifest = self.ckpt.save(name, tree)
        self.sync()
        rec = {"name": name, "s": time.perf_counter() - t, "device_wave_s": self._wave_s,
               "leaves": len(manifest["leaves"]), "ref_only": sum(e["ref"] for e in manifest["leaves"])}
        rec.update({k: v - before[k] for k, v in self.ckpt.stats.items() if k != "leaves_ref_only"})
        self.saves.append(rec)
        return manifest


def _bits(t):
    """A tensor's bits as an integer tensor of its element size."""
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def state_bits_differ(a: dict, b: dict) -> list[str]:
    """Names of the tensors of two train states whose dtype, shape or bits
    differ (parameters by name, each optimizer tree by name, the step)."""
    import torch

    pa, pb = dict(a["params"].named_parameters()), dict(b["params"].named_parameters())
    pairs = [(f"params/{n}", pa[n], pb.get(n)) for n in pa]
    for k in ("master", "mu", "nu", "err"):
        for n, t in a["opt"].get(k, {}).items():
            pairs.append((f"opt/{k}/{n}", t, b["opt"].get(k, {}).get(n)))
    pairs.append(("opt/step", a["opt"]["step"], b["opt"]["step"]))
    return [name for name, x, y in pairs
            if y is None or x.dtype != y.dtype or x.shape != y.shape or not torch.equal(_bits(x), _bits(y))]


def batch_loss(model, params, data, step: int) -> float:
    """``loss_fn`` on step ``step``'s batch, without autograd."""
    import torch

    batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(step).items()}
    with torch.no_grad():
        return float(model.loss_fn(params, batch)[0])


def train_traffic(model, data, cluster, ckpt, opt, seed: int, sync) -> tuple[dict, dict]:
    """Phase 4b's traffic, after ``examples/train_e2e.py``, through the
    port's train loop and ``ckpt``, a ``TimedSaves``: steps 0-1 saving
    step-2; the live loss on step 2's batch; ``crash_node``, ``add_node``,
    ``scrub``; restore step-2 with ``like=`` (bitwise against the live
    state, the same loss on step 2's batch within 1e-3 relative); an
    identical re-save (all ref-only, 0 B sent); steps 2-3 resumed saving
    step-4. Every save makes 1 cut + 1 fingerprint launch. Returns (the
    final state, the measurements)."""
    from repro_torch.models.convert import train_state_from_tree, train_state_to_tree
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.train.loop import init_train_state

    cfg = model.cfg

    def tcfg(steps: int) -> TrainConfig:
        return TrainConfig(steps=steps, accum=TRAIN_ACCUM, log_every=1, checkpoint_every=2, opt=opt)

    state, hist = train_loop(model, data, tcfg(2), generator=seed, checkpointer=ckpt)
    live_loss = batch_loss(model, state["params"], data, 2)
    cluster.crash_node("oss3")
    cluster.add_node()
    cluster.scrub()
    template = train_state_to_tree(init_train_state(model, seed, opt), cfg)
    sync()
    t = time.perf_counter()
    tree = ckpt.ckpt.restore("step-2", like=template)
    sync()
    restore_s = time.perf_counter() - t
    del template
    restored = train_state_from_tree(tree, cfg, model.device)
    del tree
    differ = state_bits_differ(state, restored)
    _check(not differ, f"restore of step-2 is not bitwise equal to the live state: {differ[:5]}")
    restored_loss = batch_loss(model, restored["params"], data, 2)
    _check(abs(restored_loss - live_loss) <= 1e-3 * abs(live_loss),
           f"step 2's loss: restored {restored_loss} != live {live_loss}")
    del state
    ckpt.save("step-2-again", train_state_to_tree(restored, cfg))
    again = ckpt.saves[-1]
    _check(again["ref_only"] == again["leaves"] and again["bytes_sent"] == 0,
           f"the re-save of the restored state wrote leaves: {again}")
    state, hist2 = train_loop(model, data, tcfg(4), checkpointer=ckpt, state=restored, start_step=2)
    losses = [h["loss"] for h in hist + hist2]
    _check(len(losses) == 4 and all(math.isfinite(x) for x in losses), f"losses {losses}")
    _check([s["name"] for s in ckpt.saves] == ["step-2", "step-2-again", "step-4"], f"saves {ckpt.saves}")
    for s in ckpt.saves:
        _check((s["cdc_launches"], s["fp_launches"]) == (1, 1), f"save {s['name']}: launches {s}")
    return state, {
        "steps": [{"step": h["step"], "loss": h["loss"], "s": h["sec"]} for h in hist + hist2],
        "live_loss_step2": live_loss, "restored_loss_step2": restored_loss,
        "saves": ckpt.saves, "restore_s": restore_s,
        "space_savings": cluster.space_savings(),
    }


def _rss_bytes() -> tuple[int, int]:
    """(current, peak) resident set size of this process, in bytes."""
    import resource

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * resource.getpagesize(), resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _warm_cublas() -> None:
    """A small matmul forward and backward on the card, so the cuBLAS
    workspaces of the main thread and of autograd's device thread exist
    before a phase reads ``memory_allocated()`` (they live on)."""
    import torch

    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones((64, 64), dtype=dt, device="cuda", requires_grad=True)
        (a @ a).sum().backward()
    torch.cuda.synchronize()


def train_wave_check(state, cfg, spec, fp_ops_per_word: float) -> dict:
    """The cut and fingerprint kernels at the train path's shapes: the wave
    of the train state's tree, which a save sends through them (49 streams,
    9.78 GB at full width). Holds the cut positions and counts, and every
    fingerprint row's fingerprint, against the twins; times the kernels on
    the card (CUDA events) and the twins on the host clock. Its launches
    are outside any path's count."""
    from repro_torch.checkpoint.dedup_ckpt import _leaf_paths
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc import cdc_cut_positions_cuda
    from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda
    from repro_torch.models.convert import train_state_to_tree

    streams = [ops.tensor_to_u8(leaf) for _, leaf in _leaf_paths(train_state_to_tree(state, cfg))]
    n_streams = len(streams)
    kw = spec.kernel_kwargs()
    check = TwinCheck()
    cuts, cut_plain_ms = check.cuts(streams, kw, "cut-positions kernel on the train state's wave")
    m_cut = sum(int(p.numel()) for p, _, _ in cuts)
    n_chunks = sum(k for _, _, k in cuts)
    del cuts
    cut_ms = _timed(lambda: cdc_cut_positions_cuda(streams, **kw), 3)
    wave_bytes = sum(int(s.numel()) for s in streams)
    cut_bound = cut_bound_ms(wave_bytes, m_cut, len(streams))
    rows, _ = ops.cut_wave_rows(streams, **kw)
    del streams
    fps = fingerprint_chunks_cuda(rows)
    fp_plain_ms = check.fingerprints(rows, fps, "fingerprint kernel on the train state's wave")
    fp_ms = _timed(lambda: fingerprint_chunks_cuda(rows), 3)
    c_rows, width = rows.shape
    fp_bound = fp_bound_ms(c_rows, width, fp_ops_per_word)
    del rows, fps
    _check(c_rows == n_chunks, f"the train wave's rows {c_rows} != its chunks {n_chunks}")

    def row(kind: str, ms: float, plain_ms: float, bound: tuple[float, float], shape: str) -> dict:
        return {"mismatches": check.mismatches[kind], "max_abs_err": check.err[kind], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(bound),
                "bound_by": "bytes" if bound[0] >= bound[1] else "operations", "shape": shape}

    return {
        "cdc_cut_positions_cuda": row("cdc_cut", cut_ms, cut_plain_ms, cut_bound,
                                      f"{n_streams} streams, {wave_bytes} B, {m_cut} cut slots"),
        "fingerprint_chunks_cuda": row("fingerprint", fp_ms, fp_plain_ms, fp_bound, f"({c_rows}, {width}) uint32"),
    }


def train_phase(seed: int, fp_ops_per_word: float) -> dict:
    """Phase 4b: the train path at full width. Returns the ``train`` line;
    the line's ``kernel_launches`` are the train path's counts,
    ``kernel_check`` the cut and fingerprint kernels against their twins
    at the train wave's shapes (``train_wave_check``), and
    ``left_allocated_bytes`` what the phase left allocated on the card
    after freeing all of it (the caller checks it is 0)."""
    import torch

    from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc import cdc_cut_positions_cuda, cdc_hashes_cuda
    from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import build_train_step

    _warm_cublas()
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS, attn_impl="dense", remat="full")
    model = build_model(cfg)
    n_front = cfg.n_frontend_tokens
    data = PatchedLMData(SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ - n_front,
                                         global_batch=TRAIN_BATCH, seed=seed),
                         n_front, cfg.d_model, cfg.param_dtype, model.device, seed)
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 256 * 1024))
    ckpt = TimedSaves(DedupCheckpointer(cluster, CheckpointConfig()), torch.cuda.synchronize)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    kernels = (cdc_cut_positions_cuda, fingerprint_chunks_cuda, cdc_hashes_cuda, flash_attention_cuda)

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    t = time.perf_counter()
    state, line = train_traffic(model, data, cluster, ckpt, opt, seed, torch.cuda.synchronize)
    traffic_s = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in kernels}
    n_saves = len(ckpt.saves)
    _check(launches["cdc_cut_positions_cuda"] == n_saves and launches["fingerprint_chunks_cuda"] == n_saves,
           f"the train path's kernel launches {launches}, want {n_saves} cut and {n_saves} fingerprint")
    peak = torch.cuda.max_memory_allocated()
    rss = _rss_bytes()

    # One more step (step 4) under the profiler, outside the counts.
    step_fn = build_train_step(model, opt, TRAIN_ACCUM)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(4).items()}
    torch.cuda.reset_peak_memory_stats()
    profile = device_profile(lambda: float(step_fn(state, batch)[1]["total_loss"]))
    step_peak = torch.cuda.max_memory_allocated()
    kernel_check = train_wave_check(state, cfg, ckpt.ckpt.spec, fp_ops_per_word)

    n_params = sum(p.numel() for p in state["params"].parameters())
    state_bytes = sum(p.numel() * p.element_size() for p in state["params"].parameters()) + \
        sum(t.numel() * t.element_size() for k in ("master", "mu", "nu") for t in state["opt"][k].values())
    positions = TRAIN_BATCH * TRAIN_SEQ
    step_s = [s["s"] for s in line["steps"]]
    line = {
        "model": f"{cfg.arch_id}, {cfg.n_layers} layers, full width, {cfg.param_dtype}, attn_impl "
                 f"{cfg.attn_impl}, remat {cfg.remat}, random weights",
        "shape": f"train_4k: {n_front} patch + {TRAIN_SEQ - n_front} text positions, global batch "
                 f"{TRAIN_BATCH} in {TRAIN_ACCUM} microbatches",
        "reduced": {"n_layers": [32, TRAIN_LAYERS], "global_batch": [256, TRAIN_BATCH]},
        "cluster": "4 nodes, 2 replicas, fixed 256 KiB chunks; device CDC (CheckpointConfig())",
        "params": n_params, "state_bytes": state_bytes,
        "leaves": ckpt.saves[0]["leaves"],
        **line,
        "step_s": step_s,
        "tokens_per_s": [positions / s for s in step_s],
        "profile_step4": profile,
        "step_peak_memory_bytes": step_peak,
        "peak_memory_bytes": peak,
        "traffic_s": traffic_s,
        "bytes_sent": sum(s["bytes_sent"] for s in ckpt.saves),
        "host_rss_bytes": {"current": rss[0], "peak": rss[1]},
        "kernel_launches": launches,
        "kernel_check": kernel_check,
    }
    del state, batch, step_fn, ckpt, cluster, model, data
    gc.collect()
    torch.cuda.empty_cache()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    line["host_rss_bytes"]["after_free"] = _rss_bytes()[0]
    return line


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the flash kernel's mask keeps visible."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_ms(q, k, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) lower bounds in ms of one flash call: 4 * hd FLOP
    per visible pair and query head over the bf16 tensor-core peak; q, k, v
    read once and the output written once over the HBM rate."""
    b, sq, h, hd = q.shape
    flop = 4 * b * h * hd * attention_pairs(sq, k.shape[1], causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flop / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def band_mask(s: int, window: int, device):
    """(s, s) bool: key j is visible to query i under the causal window
    (i - window < j <= i), the kernel's mask at Sq = Skv."""
    import torch

    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (j > i - window)


def library_attention_ms(q, k, v, window: int, reps: int = 5) -> tuple[float, str]:
    """PyTorch's ``scaled_dot_product_attention`` on the kernel's inputs
    ((B, S, H, hd), transposed to its layout), ``enable_gqa``: causal, or
    with a boolean band mask for a window. Timed under each fused backend
    that takes the call (flash, memory-efficient, cuDNN), the math backend
    only when none does; returns the fastest time and its backend's name."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    kw = {"attn_mask": band_mask(q.shape[1], window, q.device)} if window else {"is_causal": True}
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        if times and backend == SDPBackend.MATH:
            break
        with sdpa_kernel([backend]):
            try:  # a backend that does not take these inputs raises before it launches
                F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
            except RuntimeError:
                continue
            times[backend.name] = _timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw),
                                         reps)
    _check(bool(times), "no scaled_dot_product_attention backend takes the call")
    name = min(times, key=times.get)
    return times[name], name


class FlashCheck:
    """Holds the flash kernel against its plain version and keeps, over
    every comparison, the count of elements beyond ``FLASH_RTOL`` (NaN
    included), the max |kernel - plain| and the max ratio of the error to
    the limit's scale (|plain| + row RMS) per dtype. ``strict`` raises at
    the first comparison with an element beyond; otherwise the comparisons
    that failed are listed in ``failed``. Its own launches are subtracted
    from no path's count: the paths' counts are read before and after their
    runs only."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.mismatches = 0
        self.cases = 0
        self.failed: list[tuple[str, int]] = []
        self.max_abs_err = {"float32": 0.0, "bfloat16": 0.0}
        self.max_err_ratio = {"float32": 0.0, "bfloat16": 0.0}

    def __call__(self, q, k, v, *, causal: bool, window: int, what: str):
        import torch

        from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain

        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        exp = flash_attention_plain(q, k, v, causal=causal, window=window)
        _check(got.shape == exp.shape and got.dtype == q.dtype, f"{what}: {got.shape} {got.dtype}")
        dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
        ratio = flash_err_ratio(got, exp)
        n_bad = int((~(ratio <= FLASH_RTOL[dt])).sum())
        self.cases += 1
        self.mismatches += n_bad
        self.max_abs_err[dt] = max(self.max_abs_err[dt], float((got.float() - exp.float()).abs().max()))
        self.max_err_ratio[dt] = max(self.max_err_ratio[dt], float(ratio.max()))
        if n_bad:
            self.failed.append((what, n_bad))
        _check(not (self.strict and n_bad), f"{what}: {n_bad} elements beyond tolerance {FLASH_RTOL[dt]}")
        return got


def flash_err_ratio(got, exp):
    """|got - exp| / (|exp| + the RMS of exp's row over the last dim), in
    float32; 0 where the two are equal, inf where only exp's row is 0."""
    import torch

    e = exp.float()
    d = (got.float() - e).abs()
    scale = e.abs() + e.square().mean(dim=-1, keepdim=True).sqrt()
    return torch.where(d == 0, 0.0, d / scale)


def flash_grid_phase(check: FlashCheck, gen) -> None:
    """Phase 5: the kernel against its plain version on the card."""
    import torch

    def qkv(sq, skv, h, kh, hd, dtype):
        return [torch.randn(shape, generator=gen, device=gen.device).to(dtype)
                for shape in ((1 if sq > 256 else 2, sq, h, hd), (1 if sq > 256 else 2, skv, kh, hd),
                              (1 if sq > 256 else 2, skv, kh, hd))]

    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            for h, kh in ((4, 4), (4, 2), (8, 1)):
                check(*qkv(256, 256, h, kh, 32, dtype), causal=causal, window=window,
                      what=f"flash {dtype} causal={causal} window={window} H={h} K={kh}")
        for sq, skv, h, kh, hd, causal, window in (
            (700, 700, 40, 8, 128, True, 0), (64, 256, 4, 2, 32, False, 0), (300, 100, 4, 2, 64, True, 64),
            (1000, 1000, 8, 2, 64, True, 0), (4097, 4097, 8, 2, 128, True, 0), (4097, 1000, 8, 2, 128, True, 64),
            (257, 257, 40, 8, 128, True, 129), (384, 255, 4, 2, 32, False, 0), (640, 640, 8, 2, 64, True, 100),
        ):
            check(*qkv(sq, skv, h, kh, hd, dtype), causal=causal, window=window,
                  what=f"flash {dtype} Sq={sq} Skv={skv} H={h} K={kh} hd={hd} causal={causal} window={window}")
    torch.cuda.synchronize()


def profile_calls(fn, reps: int) -> dict:
    """Run ``fn`` ``reps`` times under ``torch.profiler``. Per call: wall
    ms, device ms of all device work, their difference (the host gap),
    device ms and launches by name, and the host operations with the most
    self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    by_name, host = {}, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0) if us is None else us
            by_name[e.key[:100]] = [us / 1e3 / reps, e.count / reps]
        else:
            host.append((e.self_cpu_time_total / 1e3 / reps, e.key[:60], e.count / reps))
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"wall_ms_per_call": wall_ms, "device_ms_per_call": device_ms,
            "host_gap_ms_per_call": wall_ms - device_ms, "by_name": by_name,
            "host_ops": [[name, ms, n] for ms, name, n in sorted(host, reverse=True)[:8]]}


def device_ms_of(prof: dict, pattern: str) -> float:
    """Device ms per launch of the work in a ``profile_calls`` result whose
    name holds ``pattern`` (summed over the names): the device ms per call
    of work launched once a call. Per launch, not per call, because the
    trace can miss a call's events (0.9 launches a call has been read)."""
    return sum(ms / n for name, (ms, n) in prof["by_name"].items() if pattern in name and n)


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its wall ms (profiler on),
    the summed device time of the CUDA work it ran, the idle share of the
    device over the wall time, and the five kernels with the most device
    time. ``device_ms`` is None when the trace holds no device time."""
    return profile_summary(profile_calls(fn, 1))


def profile_summary(prof: dict) -> dict:
    """``device_profile``'s summary of one call's ``profile_calls`` result."""
    wall_ms = prof["wall_ms_per_call"]
    device_ms = prof["device_ms_per_call"] if prof["by_name"] else None
    top = sorted(prof["by_name"].items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "kernels": round(sum(n for _, n in prof["by_name"].values())),
        "idle_share": None if device_ms is None else 1 - device_ms / wall_ms,
        "top": [[name[:90], ms, round(n)] for name, (ms, n) in top],
    }


def layer0_qkv(params, cfg, tokens, layer: int = 0):
    """A layer's post-rope q, k, v at the prefill's shape, as ``mha`` makes
    them from the embedded tokens (layer 0's own input)."""
    import torch

    from repro_torch.models import layers as L

    blk = params.blocks[layer]
    b, s = tokens.shape
    hd = cfg.resolved_head_dim
    with torch.no_grad():
        h = L.rms_norm(blk.norm1, L.embed(params.embed, tokens), cfg.norm_eps)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        q = L.apply_rope(L.dense(blk.attn.wq, h).reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
        k = L.apply_rope(L.dense(blk.attn.wk, h).reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        v = L.dense(blk.attn.wv, h).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def prefill_phase(model, params, check: FlashCheck, gen) -> tuple[dict, dict]:
    """Phase 6: full-width prefill and decode. Returns the ``prefill`` line
    and the flash kernel's row of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain

    cfg = model.cfg
    dev = model.device
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_TOKENS), generator=gen, device=dev)
    torch.cuda.synchronize()
    flash_attention_cuda.launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens}, cache_len=PREFILL_CACHE)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    prefill_launches = flash_attention_cuda.launches
    _check(prefill_launches == cfg.n_layers, f"prefill launched the flash kernel {prefill_launches} times")
    _check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
           f"prefill logits {tuple(logits.shape)} not finite")
    kshape = tuple(caches[0][0]["k"].shape)
    _check(kshape == (cfg.n_layers, 1, PREFILL_CACHE, cfg.n_kv_heads, cfg.resolved_head_dim), f"cache {kshape}")
    toks = [int(torch.argmax(logits[0, -1]))]
    t = time.perf_counter()
    for i in range(DECODE_TOKENS):
        step = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, step, PREFILL_TOKENS + i)
        toks.append(int(torch.argmax(logits[0, -1])))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t
    _check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    decode_launches = flash_attention_cuda.launches - prefill_launches
    _check(decode_launches == 0, f"decode launched the flash kernel {decode_launches} times")
    peak = torch.cuda.max_memory_allocated()

    # Where the time goes: the first 4 decode steps again (same tokens and
    # positions, so the same cache entries are rewritten) and one more
    # prefill, each under the profiler. These runs are outside the counts.
    def decode4():
        for i in range(4):
            step = torch.tensor([[toks[i]]], dtype=torch.int32, device=dev)
            out, _ = model.decode_step(params, caches, step, PREFILL_TOKENS + i)
            int(torch.argmax(out[0, -1]))

    decode_profile = device_profile(decode4)
    del logits, caches
    torch.cuda.empty_cache()
    prefill_profile = device_profile(lambda: model.prefill(params, {"tokens": tokens}, cache_len=PREFILL_CACHE))
    torch.cuda.empty_cache()

    # Layer 0's attention at the path's shape: kernel, plain version, library.
    q, k, v = layer0_qkv(params, cfg, tokens)
    check(q, k, v, causal=True, window=0, what="flash on layer 0 of the prefill")
    ms = _timed(lambda: flash_attention_cuda(q, k, v), 5)
    plain_ms = _timed(lambda: flash_attention_plain(q, k, v), 2)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library_ms = _timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 5)
    ops_ms, bytes_ms = flash_bound_ms(q, k, True, 0)
    del q, k, v, qt, kt, vt
    _check(any("flash_fwd_wgmma" in name for name, _, _ in prefill_profile["top"]),
           f"flash_fwd_wgmma is not among the prefill's top kernels: {prefill_profile['top']}")
    _check(ms <= 2 * library_ms, f"flash kernel {ms:.3f} ms > 2 x scaled_dot_product_attention {library_ms:.3f} ms")
    usage = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage", str(_build._lib_path("flash_attn"))],
        capture_output=True, text=True, check=True,
    ).stdout
    regs = {k: r for k, r in res_usage(usage).items() if "wgmma" in k or k == "flash_fwd_simt<256>"}
    _check(len(regs) == 5 and all(r["stack_bytes"] == r["local_bytes"] == 0 for r in regs.values()),
           f"flash_fwd_wgmma's resource usage (4 head dims) and flash_fwd_simt<256>'s: no stack or local memory: {regs}")

    weight_bytes = sum(p.numel() * p.element_size() for n, p in params.named_parameters() if not n.startswith("embed"))
    kv_bytes = 2 * cfg.n_layers * PREFILL_CACHE * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    block_params = sum(p.numel() for p in params.blocks.parameters())
    prefill_flop = 2 * block_params * PREFILL_TOKENS + cfg.n_layers * 4 * cfg.n_heads * cfg.resolved_head_dim * \
        attention_pairs(PREFILL_TOKENS, PREFILL_TOKENS, True, 0)
    line = {
        "model": f"{cfg.arch_id}, attn_impl {cfg.attn_impl}, {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "tokens": PREFILL_TOKENS, "cache_len": PREFILL_CACHE, "batch": 1,
        "prefill_s": t_prefill, "prefill_floor_s": prefill_flop / BF16_FLOP_PER_S,
        "decode_tokens": DECODE_TOKENS, "decode_ms_per_token": t_decode / DECODE_TOKENS * 1e3,
        "decode_floor_ms_weights": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_floor_ms_weights_and_kv": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
        "weight_bytes": weight_bytes, "peak_memory_bytes": peak,
        "flash_launches": {"prefill": prefill_launches, "decode": decode_launches},
        "profile_prefill": prefill_profile, "profile_decode_4_steps": decode_profile,
    }
    row = {
        "name": "flash_attention_cuda", "route": "cuda", "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn.py:32", "launches": prefill_launches,
        "mismatches": check.mismatches, "max_abs_err": max(check.max_abs_err.values()),
        "max_abs_err_by_dtype": check.max_abs_err, "max_err_ratio": check.max_err_ratio,
        "rtol": FLASH_RTOL, "cases": check.cases,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": library_ms,
        "tflops": ops_ms / ms * BF16_FLOP_PER_S * 1e-12, "resources": regs,
        "build_s": _build.build_seconds.get("flash_attn"),
        "shape": f"q (1, {PREFILL_TOKENS}, {cfg.n_heads}, {cfg.resolved_head_dim}) bf16, k/v "
                 f"(1, {PREFILL_TOKENS}, {cfg.n_kv_heads}, {cfg.resolved_head_dim}), causal",
    }
    return line, row


def serve_phase(model, params, seed: int) -> dict:
    """Phase 7: ``BatchedServer`` at full width with launch/serve.py's
    traffic. Returns the ``serving`` line."""
    import numpy as np
    import torch

    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.serving import BatchedServer, ServeConfig

    shared_prefix, suffix, gen_tokens, n_requests = 48, 8, 8, 4
    cluster = DedupCluster.create(4, chunking=ChunkingSpec("fixed", 64 * 1024))
    srv = BatchedServer(model, params, cluster, ServeConfig(max_len=shared_prefix + 64, block_tokens=8))
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, model.cfg.vocab, shared_prefix)]
    prompts = [shared + [int(t) for t in rng.integers(0, model.cfg.vocab, suffix)] for _ in range(n_requests)]
    flash_attention_cuda.launches = 0
    requests = []
    for i, prompt in enumerate(prompts + [prompts[0]]):
        t = time.perf_counter()
        r = srv.handle(prompt, gen_tokens=gen_tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        requests.append({"seconds": dt, "reused_tokens": r["reused_tokens"],
                         "computed_tokens": r["computed_tokens"], "tokens": r["tokens"]})
        want = 0 if i == 0 else shared_prefix
        _check(r["reused_tokens"] == want, f"request {i} reused {r['reused_tokens']} tokens, want {want}")
    _check(requests[-1]["tokens"] == requests[0]["tokens"], "request 0's prompt again gave other tokens")
    computed = sum(r["computed_tokens"] for r in requests)
    seconds = sum(r["seconds"] for r in requests)
    s = srv.kv.stats
    return {
        "model": f"{model.cfg.arch_id}, {model.cfg.n_layers} layers, {model.cfg.param_dtype}",
        "cluster": "4 nodes, fixed 64 KiB chunks",
        "traffic": f"{shared_prefix} shared + {suffix} random tokens, {gen_tokens} generated, blocks of 8, "
                   f"{n_requests} requests + request 0 again",
        "requests": requests, "decode_tokens_per_s": computed / seconds,
        "hit_rate": s.hit_rate, "tokens_reused": s.tokens_reused,
        "space_savings": cluster.space_savings(), "flash_launches": flash_attention_cuda.launches,
    }


def family_traffic(model, params, tokens, n_prefill: int, cache_len: int) -> dict:
    """The sliding-window families' traffic: prefill ``n_prefill`` of
    ``tokens`` (1, n) into ``cache_len``-slot caches, then decode the rest
    one token at a time (teacher-forced), then prefill all of them afresh.
    The flash kernel's counts are set to 0 just before the prefill and read
    after it and after the decode; the fresh prefill is the check, outside
    the counts. Returns seconds, counts, and the relative max error of the
    last decode step's logits against the fresh prefill's last logits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    flash_attention_cuda.launches = flash_attention_cuda.windowed_launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    t = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens[:, :n_prefill]}, cache_len=cache_len)
    sync()
    prefill_s = time.perf_counter() - t
    launches = {"prefill": flash_attention_cuda.launches, "prefill_windowed": flash_attention_cuda.windowed_launches}
    _check(bool(logits.float().isfinite().all()), "prefill logits not finite")
    t = time.perf_counter()
    for pos in range(n_prefill, tokens.shape[1]):
        logits, caches = model.decode_step(params, caches, tokens[:, pos : pos + 1], pos)
    sync()
    decode_s = time.perf_counter() - t
    launches["decode"] = flash_attention_cuda.launches - launches["prefill"]
    ref, _ = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    a, b = logits[:, 0].float(), ref[:, 0].float()
    err = float((a - b).abs().max() / (b.abs().max() + 1e-6))
    return {"prefill_s": prefill_s, "decode_ms_per_token": decode_s / (tokens.shape[1] - n_prefill) * 1e3,
            "flash_launches": launches, "decode_vs_prefill_rel_err": err, "caches": caches}


# The sliding-window families (phase 8): arch, from src/repro/configs/; the
# flash launches a prefill must make (one per attention layer) and how many
# of them carry a window.
FAMILIES = (("gemma3-12b", 48, 40), ("recurrentgemma-2b", 8, 8))
# The last decode step's logits against a fresh prefill, relative max error:
# bfloat16 at the reference's test_local_attention_ring_cache_exactness
# limit; float32, where a decode and a prefill differ only in the order of
# their sums, at the reference's float32 tolerance.
DECODE_REL_LIMIT = {"bfloat16": 0.05, "float32": 2e-4}


def family_phase(arch: str, want_launches: int, want_windowed: int, check: FlashCheck, gen) -> tuple[dict, dict]:
    """Phase 8 for one model: full width, all layers, ``attn_impl="chunked"``,
    bf16, random weights from ``gen``; ``family_traffic`` at the prefill
    phase's size (8,192 tokens into 8,200-slot caches, 8 decode steps).
    Then the flash kernel at the model's attention shapes (the first
    attention layer's q, k, v of the embedded tokens), with and without
    the window as the model's layers use it, bf16 and float32: held
    against the plain version, timed beside it and beside
    ``scaled_dot_product_attention``. Last, the same traffic on the model
    in float32 (weights drawn afresh), whose decode must meet the prefill
    within ``DECODE_REL_LIMIT["float32"]``. Returns the ``family`` line and
    the kernel's entries for the ``kernels`` line; the caller checks that
    the phase left nothing allocated."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain
    from repro_torch.models import build_model

    _warm_cublas()
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked")
    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    # floors: the blocks' products (2 FLOP a parameter and token) and the
    # attention's visible pairs over the bf16 peak; a decode step reads
    # every weight once, the tied embedding included (it is the unembedding)
    layer_params = sum(p.numel() for p in params.blocks.parameters()) + sum(p.numel() for p in params.tail.parameters())
    hd = cfg.resolved_head_dim
    attn_flop = cfg.n_groups * sum(
        4 * cfg.n_heads * hd * attention_pairs(PREFILL_TOKENS, PREFILL_TOKENS, True, cfg.window if kind == "attn_local" else 0)
        for kind in cfg.block_pattern if kind != "rglru")
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_CACHE), generator=gen, device=model.device)
    torch.cuda.reset_peak_memory_stats()
    traffic = family_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    peak = torch.cuda.max_memory_allocated()
    launches = traffic["flash_launches"]
    check_family_traffic(arch, traffic, want_launches, want_windowed, "bfloat16")
    rings = [c for c in traffic.pop("caches")[0] if "pos_idx" in c]
    _check(all(int(c["pos_idx"].max()) == PREFILL_CACHE - 1 for c in rings), f"{arch}: ring caches missed a decode step")
    raw = profile_calls(lambda: model.prefill(params, {"tokens": tokens[:, :PREFILL_TOKENS]}, cache_len=PREFILL_CACHE), 1)
    prof = profile_summary(raw)
    flash_ms = sum(ms for name, (ms, _) in raw["by_name"].items() if "flash_fwd" in name)
    del raw
    torch.cuda.empty_cache()

    layer = cfg.block_pattern.index("attn_local")
    q, k, v = layer0_qkv(params, cfg, tokens[:, :PREFILL_TOKENS], layer)
    entries = {}
    for window in [cfg.window] + ([0] if "attn_global" in cfg.block_pattern else []):
        shape = f"{arch} q {tuple(q.shape)} k/v {tuple(k.shape)}, causal, window {window}"
        check(q, k, v, causal=True, window=window, what=f"flash at {shape}, bf16")
        check(q.float(), k.float(), v.float(), causal=True, window=window, what=f"flash at {shape}, float32")
        torch.cuda.synchronize()
        ms = _timed(lambda: flash_attention_cuda(q, k, v, window=window), 5)
        plain_ms = _timed(lambda: flash_attention_plain(q, k, v, window=window), 2)
        library_ms, backend = library_attention_ms(q, k, v, window)
        ops_ms, bytes_ms = flash_bound_ms(q, k, True, window)
        entries[shape] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms, "library_call": f"scaled_dot_product_attention ({backend})"
                                                      + (", boolean band mask" if window else ", is_causal"),
            "tflops": ops_ms / ms * BF16_FLOP_PER_S * 1e-12,
            "launches_per_prefill": launches["prefill_windowed"] if window
            else launches["prefill"] - launches["prefill_windowed"],
        }
    del q, k, v
    line = {
        "model": f"{arch}, attn_impl chunked, {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "parameters": n_params, "init_s": init_s, "tokens": PREFILL_TOKENS, "cache_len": PREFILL_CACHE, "batch": 1,
        "window": cfg.window, **traffic, "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
        "prefill_floor_s": (2 * layer_params * PREFILL_TOKENS + attn_flop) / BF16_FLOP_PER_S,
        "decode_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "profile_prefill": prof, "prefill_flash_device_ms": flash_ms,
        "prefill_flash_share": None if not prof["device_ms"] else flash_ms / prof["device_ms"],
    }
    del model, params, rings, traffic
    gc.collect()
    torch.cuda.empty_cache()

    model = build_model(dataclasses.replace(cfg, param_dtype=torch.float32))
    params = model.init(gen)
    traffic = family_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    del traffic["caches"], model, params, tokens
    check_family_traffic(arch, traffic, want_launches, want_windowed, "float32")
    line["float32"] = traffic
    gc.collect()
    torch.cuda.empty_cache()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line, entries


def check_family_traffic(arch: str, traffic: dict, want_launches: int, want_windowed: int, dtype: str) -> None:
    """``family_traffic``'s counts and its decode-vs-prefill error, against
    ``FAMILIES`` and ``DECODE_REL_LIMIT``."""
    launches = traffic["flash_launches"]
    _check(launches == {"prefill": want_launches, "prefill_windowed": want_windowed, "decode": 0},
           f"{arch}, {dtype}: flash launches {launches}, want {want_launches} a prefill "
           f"({want_windowed} windowed), 0 a decode")
    _check(traffic["decode_vs_prefill_rel_err"] < DECODE_REL_LIMIT[dtype],
           f"{arch}, {dtype}: decode after {DECODE_TOKENS} steps is {traffic['decode_vs_prefill_rel_err']} "
           f"from a full prefill (limit {DECODE_REL_LIMIT[dtype]})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.3f} s for {sorted(_build.SIGNATURES)}")
    for name, log in sorted(_build.ptxas_reports.items()):
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"ptxas {name}: " + " | ".join(regs))
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    fp_sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._lib_path("fingerprint"))],
        capture_output=True, text=True, check=True,
    ).stdout
    fp_issued_per_word, fp_ops_per_word = sass_ops_per_word(fp_sass, "fp_accumulate")
    print(f"fp_accumulate SASS: its loop issues {fp_issued_per_word} instructions per word, "
          f"{fp_ops_per_word} of them integer operations on the loaded word (the bound's count)")

    rows_out = dedup_phases(args.seed, fp_ops_per_word, fp_issued_per_word)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ 4b. the train path at full width
    train = train_phase(args.seed, fp_ops_per_word)
    print("train " + json.dumps(train))
    _check(train["left_allocated_bytes"] == 0, f"the train phase left {train['left_allocated_bytes']} B on the card")
    # ``launches`` stays the checkpoint path's count, as the row's other
    # numbers are of its wave; the train path's count and its wave's numbers
    # ride beside them.
    for row in rows_out:
        row["launches_by_path"] = {"checkpoint": row["launches"], "train": train["kernel_launches"][row["name"]]}
        if row["name"] in train["kernel_check"]:
            row["train_wave"] = train["kernel_check"][row["name"]]

    # --------------------------------------- 5. flash kernel vs plain version
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    check = FlashCheck()
    flash_grid_phase(check, gen)
    print("flash vs plain: " + json.dumps({"cases": check.cases, "mismatches": check.mismatches,
                                           "max_abs_err": check.max_abs_err,
                                           "max_err_ratio": check.max_err_ratio, "rtol": FLASH_RTOL}))
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ 6. prefill at full width, 64 layers
    model = build_model(dataclasses.replace(get_config("qwen2.5-32b"), attn_impl="chunked"))
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t:.3f} s for {sum(p.numel() for p in params.parameters())} parameters")
    prefill, flash_row = prefill_phase(model, params, check, gen)
    print("prefill " + json.dumps(prefill))

    # --------------------------------------------- 7. serving at full width
    print("serving " + json.dumps(serve_phase(model, params, args.seed)))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------- 8. the sliding-window families at full width
    flash_row["launches_by_path"] = {"qwen2.5-32b prefill": flash_row["launches"]}
    flash_row["hd256"] = {}
    for arch, want, want_windowed in FAMILIES:
        line, entries = family_phase(arch, want, want_windowed, check, gen)
        print("family " + json.dumps(line))
        _check(line["left_allocated_bytes"] == 0,
               f"the {arch} phase left {line['left_allocated_bytes']} B on the card")
        flash_row["launches_by_path"][f"{arch} prefill"] = line["flash_launches"]["prefill"]
        flash_row["hd256"].update(entries)
    flash_row.update(mismatches=check.mismatches, cases=check.cases, max_abs_err=max(check.max_abs_err.values()),
                     max_abs_err_by_dtype=check.max_abs_err, max_err_ratio=check.max_err_ratio)
    rows_out.append(flash_row)
    print(json.dumps({"kernels": rows_out}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
