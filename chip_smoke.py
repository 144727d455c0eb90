#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU: the dedup checkpoint
save, training with dedup checkpoints at the full width of
LLaVA-NeXT-Mistral-7B, Qwen1.5-MoE-A2.7B and Mamba2-1.3B, training through
the flash kernels in both directions (LLaVA-NeXT), Qwen2.5-32B
prefill and prefix-cache serving at full width, the sliding-window
families (Gemma3-12B, RecurrentGemma-2B), Qwen1.5-MoE-A2.7B, Mamba2-1.3B
and Whisper-tiny, and MiniCPM3-4B's
multi-head latent attention at full width, and the mesh and dry-run layer
(a (1, 1) mesh over the card, the production mesh's dry runs).

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
4b-4d. the train path at full width, cut in depth and batch only
   (``TRAIN_PHASES``, ``train_phase``), bf16, ``attn_impl="dense"``,
   ``remat="full"``, the port's own random init from ``--seed``, shape
   ``train_4k`` from ``SyntheticLMData``, global batch 2 in 2
   microbatches, AdamW; the state checkpointed by ``train_loop``'s hook
   through ``DedupCheckpointer`` on ``DedupCluster.create(4, replicas=2,
   chunking=ChunkingSpec("fixed", 256 KiB))``. 4b: LLaVA-NeXT-Mistral-7B's
   backbone at 2 of its 32 layers (576 bf16 patch embeddings + 3,520 text
   tokens; 9.78 GB of state, 49 leaves) with ``examples/train_e2e.py``'s
   traffic (``train_traffic``): steps 0-1 saving step-2, a node crash,
   ``add_node`` and ``scrub``, a restore of step-2, an identical re-save,
   steps 2-3 resumed saving step-4. 4c: Qwen1.5-MoE-A2.7B at 1 of its 24
   layers (60 experts top-4, capacity factor 1.25, groups of 256; 16.7 GB
   of state) and 4d: Mamba2-1.3B at 8 of its 48 (4.3 GB), with
   ``family_train_traffic``: steps 0-1 saving step-2, an identical re-save
   of the live state, a restore of step-2. Each restore is bitwise the
   live state with the same loss on step 2's batch, each re-save all
   ref-only with 0 B sent; the counts are set to 0 just before the
   traffic and read just after: 1 cut + 1 fingerprint launch a save, no
   flash or window-hash launch. Then one more step under the profiler,
   its device time by operation (``profile_step_by_op``,
   ``step_categories``), the aux loss and layer 0's drop share (MoE), and
   the cut and fingerprint kernels held against their twins on the train
   state's wave (every stream's positions and counts, every fingerprint
   row) and timed there. Each phase must leave nothing allocated on the
   card (``torch.cuda.memory_allocated()`` back to its level). Each
   phase's traffic must launch the AdamW kernels for every optimizer leaf
   (``check_adamw_counts``: a norm launch a leaf and one more, an apply
   launch a leaf, each update);
4e. the train path through the flash kernels (``chunked_train_phase``):
   4b's model, shape and batch (2 of 32 layers at full width, bf16,
   ``remat="full"``, AdamW, from ``--seed``) with ``attn_impl="chunked"``,
   no checkpoint hook. (b) Step 0's loss and gradients through "chunked"
   and through "dense" from the same state and batch: the losses within
   1e-2 relative, each leaf's relative gradient error reported; (a) 3
   steps of ``train_loop``, the flash counts set to 0 before each and read
   after it: 8 forward launches (2 layers x 2 microbatches x the forward
   and its recompute) and 4 backward launches a step, exact; then a dense
   step; (d) one chunked and one dense step profiled by operation (the
   kernels under "attention (flash kernels)" by the autograd Function's
   profiler events), step seconds, tokens/s and peak memory beside the dense
   step's; (c) the model at depth 1 in float32 on one microbatch of 1 x
   4,096 (the fp32 kernels): the loss and every gradient leaf, chunked
   against dense, within rtol = atol = 2e-4; (e) nothing left allocated;
   its 3 chunked and 1 dense updates through the AdamW kernels as in 4b;
4f. the AdamW kernels (``adamw_phase``, ``adamw_row``) on the leaves of
   the benchmark's LLaVA-NeXT stage (8 of 32 layers at full width, bf16,
   2.01 B parameters) with one train step's fp32 gradients: one
   ``adamw_update`` through the kernels, then ``adamw_norm_cuda`` and
   ``adamw_apply_cuda`` against the eager norm and ``_apply_plain`` on
   clones given the same clip (mu, nu, master and the parameter bitwise,
   the norm within 1e-6), timed beside the plain route, the byte bound
   and ``torch._fused_adamw_`` (a yardstick only);
5. hold the flash-attention kernel against its plain version on the card:
   the (causal, window) x (H, K) grid, (40, 8) heads at hd 128, float32 and
   bfloat16, Sq != Skv and ragged lengths, counting the elements beyond
   tolerance (``FLASH_RTOL``: relative to each element and to its row's RMS),
   a count phases 6 and 8 add to. Then the backward kernel against its
   plain twin (``flash_bwd_phase``, ``FlashBwdCheck``): the forward's lse
   against the plain one (``FLASH_LSE_TOL``), dq, dk and dv within
   ``FLASH_BWD_RTOL`` (the forward's form of limit) plus ``FLASH_BWD_ATOL``
   x the tensor's RMS on the (causal, window) x (H, K)
   grid at hd 128 and on ragged, rectangular and other head-dim shapes, in
   float32 and bfloat16; then at each model's train shape
   (``TRAIN_ATTENTION_SHAPES``: Sq = Skv = 4,096, batch 1) checked in both
   dtypes and timed in bf16 beside the twin, its bound and
   ``scaled_dot_product_attention``'s backward (timed only); at
   LLaVA-NeXT's and RecurrentGemma-2B's shapes the bf16 backward run
   twice more, dq, dk and dv equal bit for bit (``BITWISE_SHAPES``); its
   registers and spills from ``cuobjdump -res-usage`` (no stack or local
   memory in a bf16 instance) and its SASS (``HGMMA`` in every ``wgmma``
   instance, no ``HMMA`` anywhere);
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
   of its five pairs of head dims, nor may ``flash_fwd_simt<float, 256,
   256>`` and ``flash_fwd_simt<float, 96, 64>`` (their
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
   nothing allocated on the card;
9. MoE, Mamba-2 and enc-dec at full width, bf16, random weights from
   ``--seed``, each alone on the card, each also in float32 (decode vs a
   fresh prefill within 2e-4). Qwen1.5-MoE-A2.7B (24 layers, 16 / 16
   heads x 128, 60 experts top-4 + a shared FFN; 14.3 B parameters),
   ``attn_impl="chunked"``: ``moe_traffic`` prefills 8,192 tokens at its
   capacity factor 1.25 (24 flash launches) and decodes 8 (none), then
   runs the same traffic at capacity factor 16 against a fresh prefill as
   the model routes it (reported, with the expert ids that differ: bf16
   flips near-tied experts) and with the traffic's expert choices replayed
   (within 0.05); layer 0's drop share at 1.25; layer 0's MoE FFN on its first 512 tokens in
   float32 on the card against the CPU (ids equal, within 2e-4); the flash
   kernel at its layer shape (1, 8192, 16, 128); the float32 run at depth
   4. Mamba2-1.3B (48 layers, 64 SSD heads x 64, state 128, chunk 128):
   prefill 8,064 positions, 128 decode steps, a fresh prefill of 8,192.
   Whisper-tiny (4 + 4 layers): 1,500 frame embeddings, a 440-token
   prompt, self caches padded to 448, 8 decode steps, a fresh prefill of
   448 (within 0.05). Neither launches the flash kernel. Mamba2's bf16
   error is reported only: bf16 rounding over 48 layers and 128 steps puts
   it at 0.05-0.07 by seed; the float32 runs are the checks;
10. multi-head latent attention at full width: MiniCPM3-4B (62 layers,
   40 heads, q rank 768, kv rank 256, qk head dim 64 + 32 rope, v head dim
   64; 4.07 B parameters), ``attn_impl="chunked"``, bf16, random weights
   from ``--seed``, alone on the card. ``family_traffic``: prefill 8,192
   tokens into 8,200-slot latent caches (62 flash launches at qk head dim
   96 and v head dim 64), 8 teacher-forced absorbed decode steps (none),
   the last decode logits within 0.05 of a fresh 8,200-token prefill;
   the prefill profiled. The flash kernel at layer 0's own inputs (q and
   k (1, 8192, 40, 96), v (1, 8192, 40, 64), causal) in bf16 and float32
   against the plain version, timed beside it and beside
   ``scaled_dot_product_attention``. Then the same traffic on the model
   in float32 (16.3 GB), within 2e-4. The phase must leave nothing
   allocated;
11. the mesh layer. 11b, right after phase 7 while Qwen2.5-32B is loaded:
   a world-1 NCCL process group (on a ``HashStore``) and a (1, 1)
   ("data", "model") mesh over the card; the parameters wrapped as
   DTensors (``from_local``, no copy) at ``rules_for(mesh, prefill_32k)``'s
   placements, 8,192 tokens placed by ``batch_shardings`` and prefilled
   under ``use_sharding_rules``: the logits and the k/v caches must be
   bitwise the unsharded prefill's on the same tokens, with 64 flash
   launches (counts set to 0 just before, read just after); both prefills
   timed and profiled. 11c, on the same mesh: phase 3's layer made again
   from ``--seed``, saved plainly, then again with its leaves as DTensors:
   all ref-only, 0 bytes sent, a plain re-save's manifest, 1 cut and 1
   fingerprint launch, each kernel then held against its twin on that
   wave. The process group is torn down. 11a:
   ``repro_torch.launch.train --dryrun`` (train_4k) and
   ``repro_torch.launch.serve --dryrun`` (decode_32k) for Qwen2.5-32B on
   the (16, 16) production mesh, side by side as host processes that see
   no card, started before the build and read after phase 10; each record
   must read ``status: ok``.

It prints ``main_path``, ``train``, ``train_family``, ``train_chunked``,
``adamw``, ``prefill``, ``serving``, ``family``, ``mesh_prefill``, ``mesh_save`` and ``dryrun``
JSON lines, a ``phases`` line (each phase's seconds), a ``kernels`` JSON
line, the card's name and power limit from nvidia-smi, and last ``{"ok":
true, "device": ...}``. It exits non-zero without printing a
result when torch sees no CUDA device or the repository's package is not
beside it.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
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
# The backward kernel's tolerance on dq, dk and dv: the forward's form
# (``flash_err_ratio``), rtol x (|plain| + the RMS of plain's row), plus
# ``FLASH_BWD_ATOL`` x the RMS of the whole plain gradient. A row's exact
# gradient can be 0 (a query that sees one key has dS = P (dP - delta) =
# 0, so dq = 0), and there only fp32 rounding is left: 1.5e-5 of the
# tensor's RMS between the float32 and float64 twins at 512 positions,
# 2.5e-5 to 5e-5 between the kernel and the twin at the train shapes on
# an H100. float32 rtol 2e-4, as the forward. bfloat16: the kernel rounds
# P and dS to bf16 for its products, and its outputs and the plain twin's
# are rounded to bf16; 2e-2 is about twice the sound kernel's largest
# reading (0.0101 on an H100), and the planted faults of
# tools/flash_planted_faults.py, which drop one query tile from a dK / dV
# sum or one kv tile from a dQ sum, must fail it.
FLASH_BWD_RTOL = {"float32": 2e-4, "bfloat16": 2e-2}
FLASH_BWD_ATOL = 2e-4
# The forward's log-sum-exp against the plain one: |kernel - plain| <= tol
# * (1 + |plain|), both dtypes (the scores are fp32 sums either way), and
# -inf exactly where the plain one is -inf.
FLASH_LSE_TOL = 2e-4
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
# Phase 4e: phase 4b's model and shape through attn_impl="chunked", its
# steps, and the flash launches each must make under remat="full": the
# forward and its recompute for each layer and microbatch, the backward once.
CHUNKED_STEPS = 3
CHUNKED_FORWARD_LAUNCHES = 2 * TRAIN_LAYERS * TRAIN_ACCUM
CHUNKED_BACKWARD_LAUNCHES = TRAIN_LAYERS * TRAIN_ACCUM
# Phase 4f: the AdamW kernels on the leaves of the benchmark's LLaVA-NeXT
# stage (8 of 32 layers: 2.01 B parameters), with a train step's gradients.
ADAMW_LAYERS = 8
ADAMW_REPS = 5
PREFILL_TOKENS = 8192
PREFILL_CACHE = 8200
DECODE_TOKENS = 8
# The float32 flash instances that must spill nothing, beside every bf16
# one: the largest (hd 256) and MLA's (qk 96, v 64).
SIMT_NO_SPILL = ("flash_fwd_simt<256, 256>", "flash_fwd_simt<96, 64>")
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
    ``cuobjdump -res-usage`` text, keyed ``name<dims>`` by its integer
    template arguments from the mangled name (``flash_fwd_wgmma<96, 64>``,
    ``flash_fwd_simt<256, 256>``), a bf16 type argument as ``bf16``
    (``flash_bwd_delta<bf16, 128>``)."""
    out = {}
    for fn, reg, stack, local in re.findall(
        r"Function ([^\s:]+):\s*REG:(\d+)\s+STACK:(\d+)\s+SHARED:\d+\s+LOCAL:(\d+)", text
    ):
        name = re.search(r"\d+([a-z_]+)I(f|13__nv_bfloat16)?((?:Li\d+E)+)", fn)
        if name:
            dims = ", ".join(["bf16"] * (name.group(2) == "13__nv_bfloat16") + re.findall(r"Li(\d+)E", name.group(3)))
            out[f"{name.group(1)}<{dims}>"] = {
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


def batch_metrics(model, params, data, step: int) -> dict:
    """``loss_fn`` on step ``step``'s batch, without autograd: the total
    loss and the loss function's metrics, as floats."""
    import torch

    batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(step).items()}
    with torch.no_grad():
        total, metrics = model.loss_fn(params, batch)
    return {"total_loss": float(total), **{k: float(v) for k, v in metrics.items()}}


def batch_loss(model, params, data, step: int) -> float:
    """``loss_fn`` on step ``step``'s batch, without autograd."""
    return batch_metrics(model, params, data, step)["total_loss"]


def train_data(cfg, device, seed: int):
    """Step batches at train_4k, global batch ``TRAIN_BATCH``:
    ``SyntheticLMData``'s tokens, with the vision stub's patch embeddings
    (``PatchedLMData``) where the arch has a front end."""
    from repro_torch.data import SyntheticLMData

    n_front = cfg.n_frontend_tokens
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ - n_front, global_batch=TRAIN_BATCH, seed=seed)
    return PatchedLMData(data, n_front, cfg.d_model, cfg.param_dtype, device, seed) if n_front else data


def check_restore(model, data, ckpt, state, like, live_loss: float, sync) -> tuple[dict, float, float]:
    """Restore step-2 through ``ckpt`` with ``like=`` (dropped once the
    restore has read it): bitwise ``state``, and its loss on step 2's batch
    within 1e-3 relative of ``live_loss``. Returns (the restored state, the
    restore's seconds, its loss)."""
    from repro_torch.models.convert import train_state_from_tree

    arch = model.cfg.arch_id
    sync()
    t = time.perf_counter()
    tree = ckpt.ckpt.restore("step-2", like=like)
    sync()
    restore_s = time.perf_counter() - t
    del like
    restored = train_state_from_tree(tree, model.cfg, model.device)
    del tree
    differ = state_bits_differ(state, restored)
    _check(not differ, f"{arch}: restore of step-2 is not bitwise equal to the live state: {differ[:5]}")
    loss = batch_loss(model, restored["params"], data, 2)
    _check(abs(loss - live_loss) <= 1e-3 * abs(live_loss), f"{arch}: step 2's loss: restored {loss} != live {live_loss}")
    return restored, restore_s, loss


def check_resave(ckpt, tree, arch: str) -> None:
    """Save ``tree``, a state saved as step-2 already, as step-2-again: every
    leaf ref-only, 0 bytes sent."""
    ckpt.save("step-2-again", tree)
    again = ckpt.saves[-1]
    _check(again["ref_only"] == again["leaves"] and again["bytes_sent"] == 0,
           f"{arch}: the identical re-save wrote leaves: {again}")


def check_saves(ckpt, names: list[str], arch: str) -> None:
    """The saves made are ``names``, each with 1 cut + 1 fingerprint launch."""
    _check([s["name"] for s in ckpt.saves] == names, f"{arch}: saves {ckpt.saves}")
    for s in ckpt.saves:
        _check((s["cdc_launches"], s["fp_launches"]) == (1, 1), f"{arch}: save {s['name']}: launches {s}")


def train_traffic(model, data, cluster, ckpt, opt, seed: int, sync, state=None) -> tuple[dict, dict]:
    """Phase 4b's traffic, after ``examples/train_e2e.py``, through the
    port's train loop and ``ckpt``, a ``TimedSaves``: from ``state``, or a
    state drawn from ``seed``, steps 0-1 saving step-2; the live metrics on
    step 2's batch; ``crash_node``, ``add_node``, ``scrub``; a restore of
    step-2 with a fresh state's layout as ``like=`` (``check_restore``); an
    identical re-save of the restored state (``check_resave``); steps 2-3
    resumed saving step-4. Returns (the final state, the measurements)."""
    from repro_torch.models.convert import train_state_to_tree
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.train.loop import init_train_state

    cfg = model.cfg

    def tcfg(steps: int) -> TrainConfig:
        return TrainConfig(steps=steps, accum=TRAIN_ACCUM, log_every=1, checkpoint_every=2, opt=opt)

    state, hist = train_loop(model, data, tcfg(2), generator=seed, checkpointer=ckpt, state=state)
    live = batch_metrics(model, state["params"], data, 2)
    cluster.crash_node("oss3")
    cluster.add_node()
    cluster.scrub()
    restored, restore_s, restored_loss = check_restore(
        model, data, ckpt, state, train_state_to_tree(init_train_state(model, seed, opt), cfg),
        live["total_loss"], sync)
    del state
    check_resave(ckpt, train_state_to_tree(restored, cfg), cfg.arch_id)
    state, hist2 = train_loop(model, data, tcfg(4), checkpointer=ckpt, state=restored, start_step=2)
    losses = [h["loss"] for h in hist + hist2]
    _check(len(losses) == 4 and all(math.isfinite(x) for x in losses), f"{cfg.arch_id}: losses {losses}")
    check_saves(ckpt, ["step-2", "step-2-again", "step-4"], cfg.arch_id)
    return state, {
        "steps": [{"step": h["step"], "loss": h["loss"], "s": h["sec"]} for h in hist + hist2],
        "live_step2": live, "restored_loss_step2": restored_loss,
        "saves": ckpt.saves, "restore_s": restore_s,
        "space_savings": cluster.space_savings(),
    }


def family_train_traffic(model, data, cluster, ckpt, opt, seed: int, sync, state=None) -> tuple[dict, dict]:
    """Phases 4c and 4d's traffic through the port's train loop and
    ``ckpt``, a ``TimedSaves``: from ``state``, or a state drawn from
    ``seed``, steps 0-1, whose hook saves step-2; an identical re-save of
    the live state (``check_resave``); a restore of step-2 with the live
    tree as ``like=`` (``check_restore``). ``cluster`` is not touched.
    Returns (the live state, the measurements)."""
    from repro_torch.models.convert import train_state_to_tree
    from repro_torch.train import TrainConfig, train_loop

    cfg = model.cfg
    tcfg = TrainConfig(steps=2, accum=TRAIN_ACCUM, log_every=1, checkpoint_every=2, opt=opt)
    state, hist = train_loop(model, data, tcfg, generator=seed, checkpointer=ckpt, state=state)
    losses = [h["loss"] for h in hist]
    _check(len(losses) == 2 and all(math.isfinite(x) for x in losses), f"{cfg.arch_id}: losses {losses}")
    check_resave(ckpt, train_state_to_tree(state, cfg), cfg.arch_id)
    live = batch_metrics(model, state["params"], data, 2)
    _, restore_s, restored_loss = check_restore(model, data, ckpt, state, train_state_to_tree(state, cfg),
                                                live["total_loss"], sync)
    check_saves(ckpt, ["step-2", "step-2-again"], cfg.arch_id)
    return state, {
        "steps": [{"step": h["step"], "loss": h["loss"], "s": h["sec"]} for h in hist],
        "live_step2": live, "restored_loss_step2": restored_loss,
        "saves": ckpt.saves, "restore_s": restore_s,
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
    9.78 GB at full width for phase 4b; 77 streams, 16.7 GB, the longest
    1.245 GB, for phase 4c). Holds the cut positions and counts of every
    stream, and every fingerprint row's fingerprint, against the twins,
    and times the twins on the host clock and the kernels on the card
    (CUDA events). Its launches are outside any path's count."""
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
    longest = max(int(s.numel()) for s in streams)
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
        "cdc_cut_positions_cuda": {**row("cdc_cut", cut_ms, cut_plain_ms, cut_bound,
                                         f"{n_streams} streams, {wave_bytes} B, {m_cut} cut slots"),
                                   "longest_stream_bytes": longest},
        "fingerprint_chunks_cuda": row("fingerprint", fp_ms, fp_plain_ms, fp_bound, f"({c_rows}, {width}) uint32"),
    }


# The train phases at full width, cut in depth (and in batch, 256 -> 2 in 2
# microbatches) only, shape train_4k: (phase, arch, published depth, depth
# run, traffic). 4b: LLaVA-NeXT-Mistral-7B's backbone
# (src/repro/configs/llava_next_mistral_7b.py) 32 -> 2, 9.78 GB of train
# state, with examples/train_e2e.py's crash, scrub and resume. 4c:
# Qwen1.5-MoE-A2.7B (qwen2_moe_a2_7b.py) 24 -> 1, as one layer and the
# untied embeddings are ~1.19 B parameters, 16.7 GB of train state at 14 B a
# parameter. 4d: Mamba2-1.3B (mamba2_1_3b.py) 48 -> 8, ~4.3 GB.
TRAIN_PHASES = (
    ("4b train, LLaVA-NeXT", TRAIN_ARCH, 32, TRAIN_LAYERS, train_traffic),
    ("4c train, Qwen1.5-MoE", "qwen2-moe-a2.7b", 24, 1, family_train_traffic),
    ("4d train, Mamba2", "mamba2-1.3b", 48, 8, family_train_traffic),
)


def profile_step_by_op(fn, categories) -> dict:
    """Run ``fn`` (one train step) once under ``torch.profiler`` with input
    shapes and a ``record_function`` range around the optimizer's update.
    Each host operation's own device time goes to its ``op_category`` among
    ``categories`` (``step_categories``); forward, recompute and backward
    operations alike (a backward operation works on its forward's
    shapes). Returns wall ms, device ms, the idle share,
    device ms and launches by category, and the five kernels with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import loop

    update = loop.adamw_update

    def labelled_update(*args, **kw):
        with record_function("adamw_update"):
            return update(*args, **kw)

    loop.adamw_update = labelled_update
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        loop.adamw_update = update
    by_cat = {name: [0.0, 0] for name, _, _ in categories}
    by_cat["other"] = [0.0, 0]
    kernels = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if not us:
            continue
        for k in e.kernels:
            kernels[k.name[:90]] = kernels.get(k.name[:90], 0.0) + k.duration / 1e3
        cat = op_category(e, categories)
        by_cat[cat][0] += us / 1e3
        by_cat[cat][1] += len(e.kernels)
    device_ms = sum(ms for ms, _ in by_cat.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": None if not device_ms else 1 - device_ms / wall_ms,
            "device_ms_by_op": {k: v for k, v in by_cat.items()},
            "top": sorted(([n, ms] for n, ms in kernels.items()), key=lambda kv: kv[1], reverse=True)[:5]}


def op_category(e, categories) -> str:
    """The category of a profiler event ``e`` (a host operation) among
    ``categories`` (name, predicate(op name, input shapes), inherited): the
    first inherited category whose predicate takes ``e`` or its nearest
    ancestor that one takes; else the first other category whose predicate
    takes ``e``; else "other"."""
    inherited = [(name, pred) for name, pred, up in categories if up]
    up = e
    while up is not None:
        shapes = _input_shapes(up.input_shapes)
        cat = next((name for name, pred in inherited if pred(up.name, shapes)), None)
        if cat is not None:
            return cat
        up = up.cpu_parent
    shapes = _input_shapes(e.input_shapes)
    return next((name for name, pred, up in categories if not up and pred(e.name, shapes)), "other")


def _input_shapes(shapes) -> list[tuple]:
    """A profiler event's input shapes as tuples, a tensor list's each."""
    out = []
    for s in shapes or []:
        if isinstance(s, (list, tuple)) and s and all(isinstance(x, (list, tuple)) for x in s):
            out.extend(tuple(x) for x in s)
        elif isinstance(s, (list, tuple)) and s:
            out.append(tuple(s))
    return out


def step_categories(cfg) -> list:
    """``profile_step_by_op``'s categories of a train step of ``cfg`` at
    ``TRAIN_SEQ`` positions a microbatch of one sequence: (name,
    predicate(op name, input shapes), inherited). Inherited, so an
    operation under them is theirs whatever its shapes:
    - the optimizer: the ``adamw_update`` range;
    - the embedding: its gather (``aten::index`` / ``aten::embedding``) and
      the backward's ``_index_put_impl_`` / ``embedding_dense_backward``,
      on the (V, D) table (the zero fill of the table's gradient before
      them goes to the unembedding and loss);
    - the flash kernels (where the arch has attention): the autograd
      Function's forward and backward (``FlashAttention``,
      ``FlashAttentionBackward``: the profiler gives a kernel launched
      from Python to the innermost operation around it, not to a
      ``record_function`` range) and the ``flash_attention_cuda`` /
      ``flash_attention_bwd_cuda`` ranges, with the lse, delta and
      gradient buffers and the copies of a strided dO (the kernels are no
      aten operations, so no shape tells them).
    The others by an operation's own input shapes:
    - the unembedding and loss: any operand with a vocabulary-sized dim;
    - dense attention (where the arch has it): an operand whose last two
      dims are (S, S) and whose leading dims hold more than one (batch,
      head) row (the scores; LLaVA-NeXT's (1, S, d_model) activations and
      (d_model, d_model) weights have S = d_model = 4,096 twice too, and
      are no scores), or a ``bmm`` whose operands hold S twice;
    - MoE: the router by its (T, E) logits or (D, E) weight; the dispatch
      and combine by an operand holding the groups' E x C slots as one dim,
      the (G, g x k, E) one-hot choices or the (G, g, E, C) slots; the
      experts by their (E, D, F) / (E, F, D) weights (also under a leading
      layer dim), the (G, E, C, .) slot activations, or the batched
      products' (E, G x C, .) operands (G groups of g tokens);
    - Mamba-2: the chunk loop by its (B, H, N, P) state; the within-chunk
      weights by the (B, NC, Q, Q, H) tensor or its (NC x H, Q, Q) batched
      form; the other fp32 SSD passes by the (B, NC, Q, H, P) activations
      and the (B, NC, H, N, P) chunk states.
    Every other operation (projections, norms, the FFN, the conv) is
    "other"."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    vocab = {cfg.vocab, cfg.padded_vocab}
    tables = {(v, cfg.d_model) for v in vocab}
    embed_ops = {"aten::index", "aten::embedding", "aten::_index_put_impl_", "aten::embedding_dense_backward"}
    seq = TRAIN_SEQ
    cats = [
        ("optimizer (adamw_update)", lambda n, sh: n == "adamw_update", True),
        ("embedding (gather, its backward)", lambda n, sh: n in embed_ops and any(s in tables for s in sh), True),
        ("unembedding and loss", lambda n, sh: any(vocab & set(s) for s in sh), False),
    ]
    if any(kind != "mamba2" for kind in cfg.block_pattern):
        flash_ops = ("FlashAttention", "FlashAttentionBackward", "flash_attention_cuda", "flash_attention_bwd_cuda")
        cats.insert(2, ("attention (flash kernels)", lambda n, sh: n in flash_ops, True))
        cats.append(("attention (dense scores)",
                     lambda n, sh: any(len(s) >= 3 and s[-2:] == (seq, seq) and math.prod(s[:-2]) > 1 for s in sh) or
                     (n == "aten::bmm" and sum(s.count(seq) for s in sh) >= 2), False))
    if cfg.n_experts:
        spec = T._moe_spec(cfg)
        e, d, f = spec.n_experts, cfg.d_model, spec.expert_d_ff
        g = MOE.group_size(spec, seq)
        c = MOE.capacity(spec, g)
        n_groups = seq // g
        weights = {(e, d, f), (e, f, d)}
        cats += [
            ("moe router (product, softmax, top-k)",
             lambda n, sh: any((s[0] == seq and s[-1] == e) or s == (d, e) for s in sh), False),
            ("moe dispatch and combine (scatters, one-hot products)",
             lambda n, sh: any(e * c in s or (len(s) == 3 and s[1:] == (g * spec.top_k, e)) or
                               (len(s) == 4 and s[1:] == (g, e, c)) for s in sh), False),
            ("moe experts (einsums)",
             lambda n, sh: any(s[-3:] in weights or (len(s) == 4 and s[1:3] == (e, c)) or
                               (len(s) == 3 and s[:2] == (e, n_groups * c)) for s in sh), False),
        ]
    if "mamba2" in cfg.block_pattern:
        s_ = T._mamba_spec(cfg)
        q, h, n_, p = s_.chunk, s_.n_heads, s_.d_state, s_.head_dim
        nc = seq // q
        cats += [
            ("ssd chunk loop (B, H, N, P) state", lambda n, sh: any(len(s) == 4 and s[1:] == (h, n_, p) for s in sh),
             False),
            ("ssd within-chunk (B, NC, Q, Q, H) weights",
             lambda n, sh: any((len(s) == 5 and s[1:] == (nc, q, q, h)) or s == (nc * h, q, q) for s in sh), False),
            ("ssd other fp32 passes (chunk states, read-out)",
             lambda n, sh: any(len(s) == 5 and s[1] == nc and s[2:] in {(q, h, p), (h, n_, p)} for s in sh),
             False),
        ]
    return cats


def train_phase(arch: str, published_layers: int, layers: int, seed: int, fp_ops_per_word: float,
                traffic) -> dict:
    """Phases 4b-4d: ``arch``'s train path at full width and ``layers``
    layers, bf16, ``attn_impl="dense"``, ``remat="full"``, random weights
    from ``seed`` (the port's own init); shape train_4k (``train_data``),
    global batch 2 in 2 microbatches, AdamW; the state checkpointed through
    ``DedupCheckpointer`` on a 4-node, 2-replica cluster with fixed 256 KiB
    chunks. ``traffic`` (``train_traffic`` or ``family_train_traffic``)
    with the counts set to 0 just before and read just after (1 cut + 1
    fingerprint launch a save, no flash or window hash, and
    ``check_adamw_counts``' optimizer launches); every parameter
    finite after it; then one more step under the profiler
    (``profile_step_by_op``), the aux loss and (MoE) layer 0's drop share on
    step 2's batch, and the cut and fingerprint kernels held against their
    twins and timed on the state's wave (``train_wave_check``). Returns
    the phase's line; ``left_allocated_bytes`` is what the phase left on
    the card after freeing all of it (the caller checks it is 0)."""
    import torch

    from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc import cdc_cut_positions_cuda, cdc_hashes_cuda
    from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import build_train_step

    t_phase = time.perf_counter()
    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    rss_before = _rss_bytes()[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, attn_impl="dense", remat="full")
    model = build_model(cfg)
    data = train_data(cfg, model.device, seed)
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 256 * 1024))
    ckpt = TimedSaves(DedupCheckpointer(cluster, CheckpointConfig()), torch.cuda.synchronize)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    kernels = (cdc_cut_positions_cuda, fingerprint_chunks_cuda, cdc_hashes_cuda, flash_attention_cuda)

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    zero_adamw_counts()
    t = time.perf_counter()
    state, line = traffic(model, data, cluster, ckpt, opt, seed, torch.cuda.synchronize)
    traffic_s = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in kernels}
    n_saves = len(ckpt.saves)
    _check(launches == {"cdc_cut_positions_cuda": n_saves, "fingerprint_chunks_cuda": n_saves,
                        "cdc_hashes_cuda": 0, "flash_attention_cuda": 0},
           f"{arch}: the train path's kernel launches {launches}, want {n_saves} cut and {n_saves} fingerprint")
    optimizer_launches = check_adamw_counts(arch, len(line["steps"]), state["opt"])
    peak = torch.cuda.max_memory_allocated()
    rss = _rss_bytes()
    nonfinite = [n for n, p in state["params"].named_parameters() if not bool(torch.isfinite(p).all())]
    _check(not nonfinite, f"{arch}: parameters not finite after the traffic: {nonfinite[:5]}")

    extra = {}
    if cfg.n_experts:
        tokens = torch.as_tensor(data.batch(2)["tokens"], device=model.device)
        extra["layer0_drop_share"] = moe_drop_share(state["params"], cfg, tokens)
        extra["capacity_factor"], extra["moe_group"] = cfg.capacity_factor, cfg.moe_group
        del tokens
    # One more step, on the batch of the step the state is at, under the
    # profiler, outside the counts.
    step_fn = build_train_step(model, opt, TRAIN_ACCUM)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(len(line["steps"])).items()}
    torch.cuda.reset_peak_memory_stats()
    profile = profile_step_by_op(lambda: float(step_fn(state, batch)[1]["total_loss"]), step_categories(cfg))
    step_peak = torch.cuda.max_memory_allocated()
    del batch, step_fn
    _free()
    wave = train_wave_check(state, cfg, ckpt.ckpt.spec, fp_ops_per_word)

    n_params = sum(p.numel() for p in state["params"].parameters())
    state_bytes = sum(p.numel() * p.element_size() for p in state["params"].parameters()) + \
        sum(t.numel() * t.element_size() for k in ("master", "mu", "nu") for t in state["opt"][k].values())
    n_front = cfg.n_frontend_tokens
    positions = f"{n_front} patch + {TRAIN_SEQ - n_front} text positions" if n_front else f"{TRAIN_SEQ} positions"
    step_s = [s["s"] for s in line["steps"]]
    line = {
        "model": f"{arch}, {cfg.n_layers} layers, full width, {cfg.param_dtype}, attn_impl {cfg.attn_impl}, "
                 f"remat {cfg.remat}, random weights (the port's init)",
        "shape": f"train_4k: {positions}, global batch {TRAIN_BATCH} in {TRAIN_ACCUM} microbatches",
        "reduced": {"n_layers": [published_layers, layers], "global_batch": [256, TRAIN_BATCH]},
        "cluster": "4 nodes, 2 replicas, fixed 256 KiB chunks; device CDC (CheckpointConfig())",
        "params": n_params, "state_bytes": state_bytes, "leaves": ckpt.saves[0]["leaves"],
        **line,
        "restore_bitwise": True,
        "step_s": step_s, "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / s for s in step_s],
        "aux_loss_step2": line["live_step2"]["aux_loss"],
        **extra,
        "save_s": {s["name"]: s["s"] for s in ckpt.saves},
        "bytes_sent": {s["name"]: s["bytes_sent"] for s in ckpt.saves},
        "profile_step": profile,
        # the profiler's own host work (input shapes, thousands of launches)
        # stretches the profiled step: its device time over the last
        # unprofiled step's wall time is the idle share without it
        "idle_share_of_unprofiled_step":
            None if not profile["device_ms"] else 1 - profile["device_ms"] / 1e3 / step_s[-1],
        "step_peak_memory_bytes": step_peak,
        "peak_memory_bytes": peak, "traffic_s": traffic_s,
        "host_rss_bytes": {"before": rss_before, "current": rss[0], "peak": rss[1]},
        "kernel_launches": launches, "optimizer_launches": optimizer_launches, "kernel_wave": wave,
    }
    _check(math.isfinite(line["aux_loss_step2"]), f"{arch}: aux loss {line['aux_loss_step2']}")
    del state, ckpt, cluster, model, data
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    line["host_rss_bytes"]["after_free"] = _rss_bytes()[0]
    line["phase_s"] = time.perf_counter() - t_phase
    return line


def step_grads(model, params, batch: dict, accum: int) -> tuple[float, dict]:
    """The loss and the gradients a train step of ``build_train_step`` takes
    on ``batch`` (the microbatches' float32 sum over ``accum``), without
    the update: (loss, {parameter name: gradient})."""
    import torch

    named = dict(params.named_parameters())
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}
    loss = 0.0
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
        total, _ = model.loss_fn(params, mb)
        for acc, g in zip(grads.values(), torch.autograd.grad(total, list(named.values()))):
            acc.add_(g)
        loss += float(total.detach()) / accum
    for acc in grads.values():
        acc.div_(accum)
    return loss, grads


def grad_errors(got: dict, exp: dict) -> dict:
    """Per gradient leaf, ||got - exp|| / ||exp||."""
    return {n: float((got[n] - e).norm() / e.norm().clamp_min(1e-30)) for n, e in exp.items()}


def flash_counts() -> dict:
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    return {"forward": flash_attention_cuda.launches, "backward": flash_attention_cuda.backward_launches}


def zero_flash_counts() -> None:
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    flash_attention_cuda.launches = flash_attention_cuda.windowed_launches = 0
    flash_attention_cuda.backward_launches = 0


def chunked_train_traffic(model, dense, data, opt, state, sync) -> tuple[dict, dict]:
    """Phase 4e's traffic. ``model`` is the arch with attn_impl="chunked",
    ``dense`` the same with "dense" (the same parameters fit both). (b)
    Step 0's loss and gradients (``step_grads``) through each on step 0's
    batch from ``state``: the losses within 1e-2 relative, each leaf's
    relative gradient error reported. (a) ``CHUNKED_STEPS`` steps of the
    port's ``train_loop`` through "chunked" with no checkpoint hook, one call a
    step, the flash counts set to 0 just before each and read just after;
    then one more step through "dense", the yardstick of (d). Returns (the
    state, the measurements)."""
    import torch

    from repro_torch.train import TrainConfig, train_loop

    batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(0).items()}
    loss_c, grads_c = step_grads(model, state["params"], batch, TRAIN_ACCUM)
    loss_d, grads_d = step_grads(dense, state["params"], batch, TRAIN_ACCUM)
    errs = grad_errors(grads_c, grads_d)
    del grads_c, grads_d, batch
    rel = abs(loss_c - loss_d) / abs(loss_d)
    _check(rel <= 1e-2, f"step 0's loss through chunked {loss_c} and dense {loss_d}: {rel} relative, limit 1e-2")

    on_card = model.device.type == "cuda"

    def run(m, state, step: int):
        tcfg = TrainConfig(steps=step + 1, accum=TRAIN_ACCUM, log_every=1, opt=opt)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_flash_counts()
        state, hist = train_loop(m, data, tcfg, state=state, start_step=step)
        sync()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        return state, {"step": step, "loss": hist[-1]["loss"], "s": hist[-1]["sec"], "peak_memory_bytes": peak,
                       "flash_launches": flash_counts()}

    chunked_steps = []
    for step in range(CHUNKED_STEPS):
        state, rec = run(model, state, step)
        chunked_steps.append(rec)
    state, dense_step = run(dense, state, CHUNKED_STEPS)
    losses = [r["loss"] for r in chunked_steps] + [dense_step["loss"]]
    _check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    return state, {
        "step0": {"loss_chunked": loss_c, "loss_dense": loss_d, "loss_rel_err": rel,
                  "grad_rel_err_max": max(errs.values()), "grad_rel_err_by_leaf": errs},
        "steps": chunked_steps, "dense_step": dense_step,
    }


def chunked_grad_check(model, dense, params, batch: dict) -> dict:
    """(c): the loss and every gradient leaf of one microbatch through
    ``model`` ("chunked") against ``dense``, held to rtol = atol = 2e-4 per
    element. Returns the errors."""
    loss_c, grads_c = step_grads(model, params, batch, 1)
    loss_d, grads_d = step_grads(dense, params, batch, 1)
    _check(abs(loss_c - loss_d) <= 2e-4 + 2e-4 * abs(loss_d), f"float32 loss: chunked {loss_c}, dense {loss_d}")
    beyond = {n: int((~((grads_c[n] - e).abs() <= 2e-4 + 2e-4 * e.abs())).sum()) for n, e in grads_d.items()}
    bad = {n: c for n, c in beyond.items() if c}
    _check(not bad, f"float32 gradient elements beyond rtol = atol = 2e-4, chunked against dense: {bad}")
    return {"loss_chunked": loss_c, "loss_dense": loss_d,
            "grad_max_abs_err": max(float((grads_c[n] - e).abs().max()) for n, e in grads_d.items()),
            "grad_rel_err_by_leaf": grad_errors(grads_c, grads_d), "leaves": len(grads_d)}


def chunked_train_phase(seed: int) -> dict:
    """Phase 4e: phase 4b's model (``TRAIN_ARCH`` at ``TRAIN_LAYERS`` layers,
    full width, bf16, ``remat="full"``, the port's init from ``seed``,
    train_4k with its patch embeddings, global batch 2 in 2 microbatches,
    AdamW) through ``attn_impl="chunked"``: the flash kernels in both
    directions. ``chunked_train_traffic`` ((a): ``CHUNKED_FORWARD_LAUNCHES``
    forward and ``CHUNKED_BACKWARD_LAUNCHES`` backward launches each step,
    exact; (b); the optimizer's launches over (a)'s steps and the dense
    one, ``check_adamw_counts``); (d) one chunked and one dense step under
    the profiler by operation (``step_categories``: the kernels under attention by the
    Function's events), the chunked steps' seconds, tokens/s and peak memory beside
    the dense step's; (c) the model at depth 1 in float32 on one microbatch
    of 1 x ``TRAIN_SEQ`` (``chunked_grad_check``: the fp32 kernels); (e)
    nothing left allocated (``left_allocated_bytes``, checked by the
    caller). Returns the ``train_chunked`` line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import build_train_step, init_train_state

    t_phase = time.perf_counter()
    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS, attn_impl="chunked", remat="full")
    model, dense = build_model(cfg), build_model(dataclasses.replace(cfg, attn_impl="dense"))
    data = train_data(cfg, model.device, seed)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, seed, opt)
    zero_adamw_counts()
    state, line = chunked_train_traffic(model, dense, data, opt, state, torch.cuda.synchronize)
    line["optimizer_launches"] = check_adamw_counts(
        f"{TRAIN_ARCH} chunked", len(line["steps"]) + 1, state["opt"])
    want = {"forward": CHUNKED_FORWARD_LAUNCHES, "backward": CHUNKED_BACKWARD_LAUNCHES}
    got = [r["flash_launches"] for r in line["steps"]]
    _check(got == [want] * CHUNKED_STEPS, f"flash launches a chunked step {got}, want {want} each")
    _check(line["dense_step"]["flash_launches"] == {"forward": 0, "backward": 0},
           f"the dense step launched the flash kernels: {line['dense_step']['flash_launches']}")

    cats = step_categories(cfg)
    profiles = {}
    for name, m in (("chunked", model), ("dense", dense)):
        step_fn = build_train_step(m, opt, TRAIN_ACCUM)
        batch = {k: torch.as_tensor(v, device=m.device) for k, v in data.batch(CHUNKED_STEPS + 1).items()}
        torch.cuda.reset_peak_memory_stats()
        profiles[name] = profile_step_by_op(lambda: float(step_fn(state, batch)[1]["total_loss"]), cats)
        profiles[name]["step_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del step_fn, batch
    del state, model, dense, data
    _free()

    # (c) depth 1, float32, one microbatch of one sequence
    cfg32 = dataclasses.replace(cfg, n_layers=1, param_dtype=torch.float32)
    m32, d32 = build_model(cfg32), build_model(dataclasses.replace(cfg32, attn_impl="dense"))
    params = m32.init(seed)
    batch = train_data(cfg32, m32.device, seed).batch(0)
    batch = {k: torch.as_tensor(v, device=m32.device)[:1] for k, v in batch.items()}
    zero_flash_counts()
    line["float32_depth1"] = chunked_grad_check(m32, d32, params, batch)
    line["float32_depth1"]["flash_launches"] = flash_counts()
    _check(line["float32_depth1"]["flash_launches"] == {"forward": 2, "backward": 1},
           f"float32 depth-1 launches {line['float32_depth1']['flash_launches']}, want 2 forward and 1 backward")
    del m32, d32, params, batch
    _free()

    step_s = [r["s"] for r in line["steps"]]
    line = {
        "model": f"{TRAIN_ARCH}, {cfg.n_layers} layers, full width, {cfg.param_dtype}, attn_impl chunked "
                 f"(the flash kernels forward and backward), remat {cfg.remat}, random weights (the port's init)",
        "shape": f"train_4k: {cfg.n_frontend_tokens} patch + {TRAIN_SEQ - cfg.n_frontend_tokens} text positions, "
                 f"global batch {TRAIN_BATCH} in {TRAIN_ACCUM} microbatches",
        "reduced": {"n_layers": [32, TRAIN_LAYERS], "global_batch": [256, TRAIN_BATCH]},
        **line,
        "step_s": step_s, "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / s for s in step_s],
        "dense_step_s": line["dense_step"]["s"],
        "dense_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / line["dense_step"]["s"],
        "profile_step": profiles["chunked"], "profile_dense_step": profiles["dense"],
    }
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    line["phase_s"] = time.perf_counter() - t_phase
    return line


def zero_adamw_counts() -> None:
    from repro_torch.kernels.adamw import adamw_apply_cuda, adamw_norm_cuda

    adamw_norm_cuda.launches = adamw_apply_cuda.launches = 0


def check_adamw_counts(what: str, updates: int, opt_state: dict) -> dict:
    """The AdamW kernels' launches since ``zero_adamw_counts``, which must
    be those of ``updates`` updates of ``opt_state``'s leaves all through
    ``csrc/adamw.cu``: a norm launch a leaf and one more, and an apply
    launch a leaf. Returns them."""
    from repro_torch.kernels.adamw import adamw_apply_cuda, adamw_norm_cuda

    leaves = sum(1 for t in opt_state["mu"].values() if t.numel())
    got = {"adamw_norm_cuda": adamw_norm_cuda.launches, "adamw_apply_cuda": adamw_apply_cuda.launches}
    want = {"adamw_norm_cuda": updates * (leaves + 1), "adamw_apply_cuda": updates * leaves}
    _check(got == want, f"{what}: the optimizer's kernel launches {got}, want {want} "
                        f"({updates} updates of {leaves} leaves through csrc/adamw.cu)")
    return got


def adamw_bound_ms(params: dict, grads: dict) -> float:
    """The bytes an AdamW step needs at the least, over the HBM rate: each
    gradient read for the norm and again for the update, mu, nu and master
    read and written, the parameter written (34 B a bf16 parameter with an
    fp32 gradient)."""
    nbytes = sum(p.numel() * (2 * grads[n].element_size() + 24 + p.element_size()) for n, p in params.items())
    return nbytes / HBM_BYTES_PER_S * 1e3


def adamw_row(params: dict, grads: dict, state: dict, opt, reps: int) -> dict:
    """The AdamW kernels on one set of leaves: ``params`` (name -> parameter
    on the card), ``grads`` (the same names), ``state`` (``adamw_init``'s,
    advanced in place) and ``opt`` (an ``AdamWConfig``).

    1. one ``adamw_update``, which must launch the kernels for every leaf
       (``check_adamw_counts``);
    2. from the state it leaves, ``adamw_norm_cuda`` and
       ``adamw_apply_cuda`` against the eager norm and ``_apply_plain`` a
       leaf on clones, given the kernel's clip: mu, nu, master and the
       parameter bitwise equal, gnorm within 1e-6 of the eager one;
    3. timed warm (CUDA events, ``reps`` calls): ``ms``, the two wrappers;
       ``plain_ms``, the eager norm and ``_apply_plain`` a leaf;
       ``library_ms``, ``torch._fused_adamw_`` on the same fp32 master,
       moments and gradients (a yardstick the port never calls: no norm,
       no parameter written); ``bound_ms``, ``adamw_bound_ms``.

    Returns the ``kernels`` line's row."""
    import torch

    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import adamw

    names = list(params)
    params = {n: params[n].detach() for n in names}
    gl = [grads[n] for n in names]
    with torch.no_grad():
        zero_adamw_counts()
        adamw.adamw_update(params, grads, state, opt)
        launches = check_adamw_counts("adamw_row", 1, state)

        lr, b1c, b2c = adamw._step_scalars(opt, state["step"] + 1)
        plain = {n: [params[n].clone()] + [state[k][n].clone() for k in ("mu", "nu", "master")] for n in names}
        leaves = [(params[n], grads[n], state["mu"][n], state["nu"][n], state["master"][n]) for n in names]
        gnorm, clip = kadamw.adamw_norm_cuda(gl, opt.grad_clip)
        kadamw.adamw_apply_cuda(leaves, clip, lr, b1c, b2c, opt)
        eager_norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in gl) + 1e-16)
        for n in names:
            p, m, v, w = plain[n]
            adamw._apply_plain(p, grads[n].float(), m, v, w, clip, lr, b1c, b2c, opt)
        mismatches, max_abs_err = {}, 0.0
        for i, key in enumerate(("param", "mu", "nu", "master")):
            mismatches[key] = 0
            for n in names:
                a = params[n] if key == "param" else state[key][n]
                b = plain[n][i]
                view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
                mismatches[key] += int((a.view(view) != b.view(view)).sum())
                max_abs_err = max(max_abs_err, float((a.float() - b.float()).abs().max()))
        gnorm_rel_err = abs(float(gnorm) / float(eager_norm) - 1.0)
        _check(not any(mismatches.values()), f"AdamW kernels against the plain update, elements that differ: "
                                             f"{mismatches}")
        _check(gnorm_rel_err <= 1e-6, f"AdamW norm {float(gnorm)} against the eager {float(eager_norm)}")

        def kernels():
            _, c = kadamw.adamw_norm_cuda(gl, opt.grad_clip)
            kadamw.adamw_apply_cuda(leaves, c, lr, b1c, b2c, opt)

        def eager():
            c = adamw._clip(torch.sqrt(sum(torch.sum(g * g) for g in gl) + 1e-16), opt)
            for n in names:
                p, m, v, w = plain[n]
                adamw._apply_plain(p, grads[n].float(), m, v, w, c, lr, b1c, b2c, opt)

        steps = [torch.ones((), dtype=torch.float32, device=gl[0].device) for _ in names]
        f32 = [[plain[n][i] for n in names] for i in (3, 1, 2)]

        def library():
            torch._fused_adamw_(f32[0], [g.float() for g in gl], f32[1], f32[2], [], steps, lr=opt.lr,
                                beta1=opt.b1, beta2=opt.b2, weight_decay=opt.weight_decay, eps=opt.eps,
                                amsgrad=False, maximize=False)

        ms = _timed(kernels, reps)
        plain_ms = _timed(eager, reps)
        library_ms = _timed(library, reps)
    bound_ms = adamw_bound_ms(params, grads)
    n_params = sum(p.numel() for p in params.values())
    pdt = sorted({str(p.dtype).removeprefix("torch.") for p in params.values()})
    gdt = sorted({str(g.dtype).removeprefix("torch.") for g in gl})
    return {
        "name": "adamw_cuda", "route": "cuda", "source": "src/repro_torch/csrc/adamw.cu",
        "replaces": None, "kernels": ["adamw_sumsq", "adamw_finish", "adamw_apply"],
        "launches": launches, "mismatches": sum(mismatches.values()), "mismatches_by_tensor": mismatches,
        "max_abs_err": max_abs_err, "gnorm_rel_err": gnorm_rel_err, "clip": float(clip),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "of_bound": bound_ms / ms,
        "library_ms": library_ms, "library": "torch._fused_adamw_ (fp32 master, moments and gradients)",
        "shape": f"{len(names)} leaves, {n_params} parameters, {'/'.join(pdt)} parameters, "
                 f"{'/'.join(gdt)} gradients",
    }


def adamw_phase(arch: str, layers: int, seed: int, reps: int = ADAMW_REPS) -> dict:
    """Phase 4f: ``arch`` at full width and ``layers`` layers, bf16,
    ``attn_impl="dense"``, ``remat="full"``, the port's init from ``seed``,
    the AdamW config of the benchmark's train cells (the port's defaults);
    one train step's fp32 gradients (``step_grads`` on train_4k's batch 0,
    ``TRAIN_ACCUM`` microbatches), then ``adamw_row`` on those leaves.
    Returns the row with the phase's seconds and what it left allocated
    (``left_allocated_bytes``, checked by the caller)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import init_train_state

    t_phase = time.perf_counter()
    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, attn_impl="dense", remat="full")
    model = build_model(cfg)
    opt = AdamWConfig()
    state = init_train_state(model, seed, opt)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in train_data(cfg, model.device, seed).batch(0).items()}
    _, grads = step_grads(model, state["params"], batch, TRAIN_ACCUM)
    del batch
    _free()
    row = adamw_row(dict(state["params"].named_parameters()), grads, state["opt"], opt, reps)
    row["model"] = f"{arch}, {layers} layers, full width, {cfg.param_dtype}, one train_4k step's gradients"
    del state, grads, model
    _free()
    row["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the flash kernel's mask keeps visible."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_ms(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) lower bounds in ms of one flash call: 2 * (dqk +
    dv) FLOP per visible pair and query head (q.k and p.v) over the bf16
    tensor-core peak; q, k, v read once and the (B, Sq, H, dv) output
    written once over the HBM rate."""
    b, sq, h, dqk = q.shape
    dv = v.shape[-1]
    flop = 2 * (dqk + dv) * b * h * attention_pairs(sq, k.shape[1], causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * q.element_size()
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


def flash_err_ratio(got, exp, floor: float = 0.0):
    """|got - exp| / (|exp| + the RMS of exp's row over the last dim +
    ``floor`` x the RMS of all of exp), in float32; 0 where the two are
    equal, inf where only exp's row is 0 (and ``floor`` is 0)."""
    import torch

    e = exp.float()
    d = (got.float() - e).abs()
    scale = e.abs() + e.square().mean(dim=-1, keepdim=True).sqrt()
    if floor:
        scale = scale + floor * e.square().mean().sqrt()
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


def flash_bwd_bound_ms(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) lower bounds in ms of one backward call: 2 * (3
    dqk + 2 dv) FLOP per visible pair and query head (q.k, dO.v and the
    products into dq, dk, dv) over the bf16 tensor-core peak; q, k, v, the
    output, dO and the lse read once and dq, dk, dv written once over the
    HBM rate."""
    b, sq, h, dqk = q.shape
    dv = v.shape[-1]
    flop = 2 * (3 * dqk + 2 * dv) * b * h * attention_pairs(sq, k.shape[1], causal, window)
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * b * sq * h * dv) * q.element_size() + 4 * b * h * sq
    return flop / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def library_attention_bwd_ms(q, k, v, dout, window: int, reps: int = 3) -> tuple[float, str]:
    """The backward of PyTorch's ``scaled_dot_product_attention`` through
    autograd on the kernel's inputs (transposed to its layout), as
    ``library_attention_ms`` calls it forward: ms of ``torch.autograd.grad``
    (CUDA events) under each fused backend that takes the call, the math
    backend only when none does; returns the fastest and its backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    kw = {"attn_mask": band_mask(q.shape[1], window, q.device)} if window else {"is_causal": True}
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        if times and backend == SDPBackend.MATH:
            break
        with sdpa_kernel([backend]):
            try:  # a backend that does not take these inputs raises before it launches
                out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
                torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
            except (RuntimeError, NotImplementedError):
                continue
            times[backend.name] = _timed(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                                         reps)
            del out
    _check(bool(times), "no scaled_dot_product_attention backend takes the backward")
    name = min(times, key=times.get)
    return times[name], name


class FlashBwdCheck:
    """Holds the backward kernel against its plain twin
    (``ref.flash_attention_bwd_plain``) on the same q, k, v, forward output,
    lse and dO (the forward kernel's output and lse, a random dO), and the
    forward kernel's lse against the plain one
    (``ref.flash_attention_lse_plain``). Keeps, over every comparison, the
    elements of dq, dk and dv beyond ``FLASH_BWD_RTOL`` and of the lse
    beyond ``FLASH_LSE_TOL`` (NaN included), the max |kernel - plain| and
    the max ratio of the error to the limit's scale per dtype and gradient.
    ``strict`` raises at the first comparison with an element beyond;
    otherwise the comparisons that failed are listed in ``failed``. Its
    launches are outside every path's count."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.mismatches = 0
        self.lse_mismatches = 0
        self.cases = 0
        self.failed: list[tuple[str, int]] = []
        self.max_abs_err = {"float32": 0.0, "bfloat16": 0.0}
        self.max_err_ratio = {dt: {"dq": 0.0, "dk": 0.0, "dv": 0.0} for dt in ("float32", "bfloat16")}
        self.max_lse_err = 0.0

    def __call__(self, q, k, v, *, causal: bool, window: int, what: str, gen):
        """Check the kernels at q, k, v and a dO drawn from ``gen``; returns
        (the forward kernel's output, its lse, dO)."""
        import torch

        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda, flash_attention_cuda

        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
        dout = torch.randn(o.shape, generator=gen, device=q.device).to(q.dtype)
        _, lse_plain = ref.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
        inf = torch.isinf(lse_plain)
        lse_err = torch.where(inf, 0.0, (lse - lse_plain).abs() / (1 + lse_plain.abs()))
        n_bad = int((~(lse_err <= FLASH_LSE_TOL)).sum()) + int((torch.isinf(lse) != inf).sum())
        self.lse_mismatches += n_bad
        self.max_lse_err = max(self.max_lse_err, float(lse_err.max()))
        got = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal, window=window)
        exp = ref.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal=causal, window=window)
        dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
        for name, g, e, x in zip(("dq", "dk", "dv"), got, exp, (q, k, v)):
            _check(g.shape == x.shape and g.dtype == q.dtype, f"{what}: {name} {tuple(g.shape)} {g.dtype}")
            ratio = flash_err_ratio(g, e, FLASH_BWD_ATOL / FLASH_BWD_RTOL[dt])
            n_bad += int((~(ratio <= FLASH_BWD_RTOL[dt])).sum())
            self.max_abs_err[dt] = max(self.max_abs_err[dt], float((g.float() - e.float()).abs().max()))
            self.max_err_ratio[dt][name] = max(self.max_err_ratio[dt][name], float(ratio.max()))
        self.cases += 1
        self.mismatches += n_bad
        if n_bad:
            self.failed.append((what, n_bad))
        _check(not (self.strict and n_bad), f"{what}: {n_bad} elements of lse, dq, dk, dv beyond tolerance")
        return o, lse, dout


def flash_bwd_grid_phase(check: FlashBwdCheck, gen) -> None:
    """Phase 5's backward part: the backward kernel against its plain twin
    on the (causal, window) x (H, K) grid at hd 128 (batch 2, 300 positions:
    no whole number of tiles), then ragged and rectangular shapes (Sq >
    Skv with a window, so late queries see no key; Sq < Skv, so late keys
    are seen by none) and every other pair of head dims, float32 and
    bfloat16."""
    import torch

    def qkv(b, sq, skv, h, kh, hd, vd, dtype):
        shapes = ((b, sq, h, hd), (b, skv, kh, hd), (b, skv, kh, vd))
        return [torch.randn(s, generator=gen, device=gen.device).to(dtype) for s in shapes]

    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            for h, kh in ((4, 4), (4, 2), (8, 1)):
                check(*qkv(2, 300, 300, h, kh, 128, 128, dtype), causal=causal, window=window, gen=gen,
                      what=f"flash bwd {dtype} causal={causal} window={window} H={h} K={kh}")
        for sq, skv, h, kh, hd, vd, causal, window in (
            (300, 100, 4, 2, 128, 128, True, 64), (100, 300, 4, 2, 128, 128, True, 0),
            (257, 129, 8, 2, 128, 128, False, 0), (1000, 1000, 8, 2, 128, 128, True, 100),
            (129, 129, 4, 2, 32, 32, True, 0), (200, 77, 4, 2, 64, 64, False, 0), (321, 321, 8, 2, 64, 64, True, 50),
            (257, 257, 4, 2, 256, 256, True, 0), (300, 300, 4, 1, 256, 256, True, 100),
            (257, 257, 8, 8, 96, 64, True, 0), (300, 129, 8, 2, 96, 64, True, 64),
        ):
            check(*qkv(1, sq, skv, h, kh, hd, vd, dtype), causal=causal, window=window, gen=gen,
                  what=f"flash bwd {dtype} Sq={sq} Skv={skv} H={h} K={kh} hd={hd}/{vd} causal={causal} "
                       f"window={window}")
    torch.cuda.synchronize()


# Each model's attention at its train shape (Sq = Skv = TRAIN_SEQ, batch 1,
# causal): (name, H, K, dqk, dv, window). At BITWISE_SHAPES the bf16
# backward runs twice more and must repeat bit for bit: LLaVA-NeXT's (the
# 4e step's) and RecurrentGemma-2B's, where one kv head makes the wrapper
# split the query heads over blocks and add their fp32 parts.
TRAIN_ATTENTION_SHAPES = (
    ("llava-next-mistral-7b", 32, 8, 128, 128, 0),
    ("qwen2.5-32b", 40, 8, 128, 128, 0),
    ("qwen2-moe-a2.7b", 16, 16, 128, 128, 0),
    ("gemma3-12b local", 16, 8, 256, 256, 1024),
    ("gemma3-12b global", 16, 8, 256, 256, 0),
    ("recurrentgemma-2b", 10, 1, 256, 256, 2048),
    ("minicpm3-4b", 40, 40, 96, 64, 0),
)
BITWISE_SHAPES = ("llava-next-mistral-7b", "recurrentgemma-2b")


def flash_bwd_entry(check: FlashBwdCheck, h: int, kh: int, dqk: int, dv: int, window: int, gen,
                    repeat: bool = False) -> dict:
    """The backward kernel at a train shape (random q, k, v): held against
    its twin in bf16 and float32, timed in bf16 (and in float32) beside the
    twin and beside ``scaled_dot_product_attention``'s backward, with its
    bound. With ``repeat`` the bf16 backward runs twice more on the same
    inputs: ``bitwise_repeat`` says whether dq, dk and dv came out equal
    bit for bit both times."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda

    shapes = ((1, TRAIN_SEQ, h, dqk), (1, TRAIN_SEQ, kh, dqk), (1, TRAIN_SEQ, kh, dv))
    q, k, v = (torch.randn(s, generator=gen, device=gen.device).to(torch.bfloat16) for s in shapes)
    what = f"flash bwd at q {shapes[0]}, k {shapes[1]}, v {shapes[2]}, window {window}"
    qf, kf, vf = q.float(), k.float(), v.float()
    of, lsef, doutf = check(qf, kf, vf, causal=True, window=window, gen=gen, what=what + ", float32")
    ms_f32 = _timed(lambda: flash_attention_bwd_cuda(qf, kf, vf, of, lsef, doutf, window=window), 2)
    del qf, kf, vf, of, lsef, doutf
    o, lse, dout = check(q, k, v, causal=True, window=window, gen=gen, what=what + ", bf16")
    torch.cuda.synchronize()
    bitwise = None
    if repeat:
        first = flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window)
        bitwise = all(all(torch.equal(a, b) for a, b in zip(first, flash_attention_bwd_cuda(
            q, k, v, o, lse, dout, window=window))) for _ in range(2))
        del first
    ms = _timed(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout, window=window), 5)
    plain_ms = _timed(lambda: ref.flash_attention_bwd_plain(q, k, v, o, lse, dout, window=window), 1)
    library_ms, backend = library_attention_bwd_ms(q, k, v, dout, window)
    ops_ms, bytes_ms = flash_bwd_bound_ms(q, k, v, True, window)
    return {
        "shape": f"q {shapes[0]}, k {shapes[1]}, v {shapes[2]} bf16, causal" + (f", window {window}" if window else ""),
        "ms": ms, "ms_float32": ms_f32, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "share_of_bound": max(ops_ms, bytes_ms) / ms,
        "library_ms": library_ms, "library_call": f"scaled_dot_product_attention backward through autograd "
                                                  f"({backend})" + (", boolean band mask" if window else ", is_causal"),
        "tflops": ops_ms / ms * BF16_FLOP_PER_S * 1e-12, "bitwise_repeat": bitwise,
    }


def flash_bwd_phase(gen) -> dict:
    """Phase 5's backward part: the grid (``flash_bwd_grid_phase``) and each
    model's train shape (``flash_bwd_entry``; bitwise repeats at
    ``BITWISE_SHAPES``), the registers and spills of each backward instance
    (``cuobjdump -res-usage``: no stack or local memory in a bf16 one) and
    its SASS (``HGMMA`` in each ``wgmma`` instance, no ``HMMA``: no
    ``mma.sync`` anywhere). Returns the ``flash_attention_bwd_cuda`` row of
    the ``kernels`` line (its launches are filled in by phase 4e's
    count)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import HEAD_DIMS

    check = FlashBwdCheck()
    flash_bwd_grid_phase(check, gen)
    grid_cases = check.cases
    by_model = {name: flash_bwd_entry(check, h, kh, dqk, dv, window, gen, repeat=name in BITWISE_SHAPES)
                for name, h, kh, dqk, dv, window in TRAIN_ATTENTION_SHAPES}
    bitwise = {name: by_model[name]["bitwise_repeat"] for name in BITWISE_SHAPES}
    _check(all(bitwise.values()), f"the bf16 backward did not repeat bit for bit: {bitwise}")
    gc.collect()
    torch.cuda.empty_cache()
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    lib = str(_build._lib_path("flash_attn_bwd"))
    usage = res_usage(subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True, text=True, check=True).stdout)
    bf16 = {k: r for k, r in usage.items() if "wgmma" in k or "dkdv_sum" in k or "<bf16" in k}
    _check(sum("wgmma" in k for k in bf16) == 2 * len(HEAD_DIMS) and
           all(r["stack_bytes"] == r["local_bytes"] == 0 for r in bf16.values()),
           f"the bf16 backward's instances must use no stack or local memory: {bf16}")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    hgmma = {re.sub(r".*flash_bwd_", "flash_bwd_", f.split("\n", 1)[0].strip())[:60]: f.count("HGMMA")
             for f in sass.split("Function : ")[1:] if "wgmma" in f.split("\n", 1)[0]}
    _check(len(hgmma) == 2 * len(HEAD_DIMS) and all(hgmma.values()) and "HMMA" not in sass,
           f"every bf16 backward instance runs HGMMA and none HMMA: {hgmma}, HMMA in the SASS: {'HMMA' in sass}")
    llava = by_model["llava-next-mistral-7b"]
    return {
        "name": "flash_attention_bwd_cuda", "route": "cuda", "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/models/layers.py:158",
        "replaces_note": "no TPU kernel: the Pallas _flash_kernel (src/repro/kernels/flash_attn.py:32) has no "
                         "backward; XLA differentiates chunked_attention's loop",
        "launches": None, "mismatches": check.mismatches, "lse_mismatches": check.lse_mismatches,
        "cases": check.cases, "grid_cases": grid_cases, "max_abs_err": max(check.max_abs_err.values()),
        "max_abs_err_by_dtype": check.max_abs_err, "max_err_ratio": check.max_err_ratio,
        "max_lse_err": check.max_lse_err, "rtol": FLASH_BWD_RTOL, "atol_of_rms": FLASH_BWD_ATOL,
        "lse_tol": FLASH_LSE_TOL,
        **{k: llava[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call")},
        "by_model": by_model, "bitwise_repeat": bitwise, "resources": usage,
        "registers_bf16": {k: r["registers"] for k, r in bf16.items()}, "hgmma_by_instance": hgmma,
        "build_s": _build.build_seconds.get("flash_attn_bwd"),
    }


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
    ops_ms, bytes_ms = flash_bound_ms(q, k, v, True, 0)
    del q, k, v, qt, kt, vt
    _check(any("flash_fwd_wgmma" in name for name, _, _ in prefill_profile["top"]),
           f"flash_fwd_wgmma is not among the prefill's top kernels: {prefill_profile['top']}")
    _check(ms <= 2 * library_ms, f"flash kernel {ms:.3f} ms > 2 x scaled_dot_product_attention {library_ms:.3f} ms")
    usage = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage", str(_build._lib_path("flash_attn"))],
        capture_output=True, text=True, check=True,
    ).stdout
    regs = {k: r for k, r in res_usage(usage).items() if "wgmma" in k or k in SIMT_NO_SPILL}
    _check(len(regs) == 5 + len(SIMT_NO_SPILL) and all(r["stack_bytes"] == r["local_bytes"] == 0 for r in regs.values()),
           f"flash_fwd_wgmma's resource usage (5 pairs of head dims) and {SIMT_NO_SPILL}'s: no stack or local "
           f"memory: {regs}")

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


def _model_on_card(cfg, gen):
    """The model of ``cfg`` on the card with random weights from ``gen``,
    and the seconds their init took."""
    import torch

    from repro_torch.models import build_model

    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _prefill_profile(fn) -> tuple[dict, float]:
    """One prefill under ``profile_calls``: its summary and the flash
    kernel's device ms."""
    raw = profile_calls(fn, 1)
    return profile_summary(raw), sum(ms for name, (ms, _) in raw["by_name"].items() if "flash_fwd" in name)


def pad_self_caches(caches: dict, slots: int) -> dict:
    """An encoder-decoder prefill's caches with the self K/V (L, B, S, K,
    hd) padded with zeros to ``slots`` positions, as a caller that decodes
    past the prompt pads them; the cross K/V as they are."""
    import torch.nn.functional as F

    pad = {n: F.pad(t, (0, 0, 0, 0, 0, slots - t.shape[2])) for n, t in caches["self"].items()}
    return {"self": pad, "cross": caches["cross"]}


def family_traffic(model, params, tokens, n_prefill: int, cache_len: int, check: bool = True, frames=None) -> dict:
    """A model's serving traffic: prefill ``n_prefill`` of ``tokens`` (1, n)
    into ``cache_len``-slot caches, then decode the rest one token at a
    time (teacher-forced), then (``check``) prefill all of them afresh. An
    encoder-decoder model's prefills also take ``frames``, and its self
    caches are padded to n slots before the decode (``pad_self_caches``).
    The flash kernel's counts are set to 0 just before the prefill and read
    after it and after the decode; the fresh prefill is the check, outside
    the counts. Returns seconds, counts, the caches, the last decode step's
    logits, and their relative max error against the fresh prefill's last
    logits (None without ``check``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    def prefill(toks):
        if frames is None:
            return model.prefill(params, {"tokens": toks}, cache_len=cache_len)
        return model.prefill(params, {"tokens": toks, "frame_embeds": frames})

    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    flash_attention_cuda.launches = flash_attention_cuda.windowed_launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    t = time.perf_counter()
    logits, caches = prefill(tokens[:, :n_prefill])
    sync()
    prefill_s = time.perf_counter() - t
    launches = {"prefill": flash_attention_cuda.launches, "prefill_windowed": flash_attention_cuda.windowed_launches}
    _check(bool(logits.float().isfinite().all()), "prefill logits not finite")
    if frames is not None:
        caches = pad_self_caches(caches, tokens.shape[1])
    t = time.perf_counter()
    for pos in range(n_prefill, tokens.shape[1]):
        logits, caches = model.decode_step(params, caches, tokens[:, pos : pos + 1], pos)
    sync()
    decode_s = time.perf_counter() - t
    launches["decode"] = flash_attention_cuda.launches - launches["prefill"]
    _check(bool(logits.float().isfinite().all()), "decode logits not finite")
    err = rel_err(logits, prefill(tokens)[0]) if check else None
    return {"prefill_s": prefill_s, "decode_ms_per_token": decode_s / (tokens.shape[1] - n_prefill) * 1e3,
            "flash_launches": launches, "decode_vs_prefill_rel_err": err, "caches": caches, "logits": logits}


def rel_err(logits, ref) -> float:
    """Relative max error of (B, 1, V) last logits against ``ref``'s."""
    a, b = logits[:, 0].float(), ref[:, 0].float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


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

    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked")
    model, params, init_s = _model_on_card(cfg, gen)
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
    del traffic["logits"]
    rings = [c for c in traffic.pop("caches")[0] if "pos_idx" in c]
    _check(all(int(c["pos_idx"].max()) == PREFILL_CACHE - 1 for c in rings), f"{arch}: ring caches missed a decode step")
    prof, flash_ms = _prefill_profile(
        lambda: model.prefill(params, {"tokens": tokens[:, :PREFILL_TOKENS]}, cache_len=PREFILL_CACHE))
    torch.cuda.empty_cache()

    layer = cfg.block_pattern.index("attn_local")
    q, k, v = layer0_qkv(params, cfg, tokens[:, :PREFILL_TOKENS], layer)
    entries = {}
    for window in [cfg.window] + ([0] if "attn_global" in cfg.block_pattern else []):
        shape = f"{arch} q {tuple(q.shape)} k/v {tuple(k.shape)}, causal, window {window}"
        entries[shape] = flash_entry(check, q, k, v, window, shape)
        entries[shape]["launches_per_prefill"] = launches["prefill_windowed"] if window \
            else launches["prefill"] - launches["prefill_windowed"]
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
    _free()

    model, params, _ = _model_on_card(dataclasses.replace(cfg, param_dtype=torch.float32), gen)
    traffic = family_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    del traffic["caches"], traffic["logits"], model, params, tokens
    check_family_traffic(arch, traffic, want_launches, want_windowed, "float32")
    line["float32"] = traffic
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line, entries


def flash_entry(check: FlashCheck, q, k, v, window: int, shape: str) -> dict:
    """The flash kernel on a model's own attention inputs (causal, with
    ``window``): held against the plain version in bf16 and float32, timed
    beside it and beside ``scaled_dot_product_attention``, with its bound."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention_cuda, flash_attention_plain

    check(q, k, v, causal=True, window=window, what=f"flash at {shape}, bf16")
    check(q.float(), k.float(), v.float(), causal=True, window=window, what=f"flash at {shape}, float32")
    torch.cuda.synchronize()
    ms = _timed(lambda: flash_attention_cuda(q, k, v, window=window), 5)
    plain_ms = _timed(lambda: flash_attention_plain(q, k, v, window=window), 2)
    library_ms, backend = library_attention_ms(q, k, v, window)
    ops_ms, bytes_ms = flash_bound_ms(q, k, v, True, window)
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms, "library_call": f"scaled_dot_product_attention ({backend})"
                                                  + (", boolean band mask" if window else ", is_causal"),
        "tflops": ops_ms / ms * BF16_FLOP_PER_S * 1e-12,
    }


def check_family_traffic(arch: str, traffic: dict, want_launches: int, want_windowed: int, dtype: str,
                         err_key: "str | None" = "decode_vs_prefill_rel_err") -> None:
    """``family_traffic``'s counts, and its decode-vs-prefill error under
    ``err_key`` (None: the error is reported, not held to a limit),
    against ``FAMILIES`` and ``DECODE_REL_LIMIT``."""
    launches = traffic["flash_launches"]
    _check(launches == {"prefill": want_launches, "prefill_windowed": want_windowed, "decode": 0},
           f"{arch}, {dtype}: flash launches {launches}, want {want_launches} a prefill "
           f"({want_windowed} windowed), 0 a decode")
    _check(err_key is None or traffic[err_key] < DECODE_REL_LIMIT[dtype],
           f"{arch}, {dtype}: {err_key} is {traffic.get(err_key)} (limit {DECODE_REL_LIMIT[dtype]})")


# Phase 9: Qwen1.5-MoE-A2.7B (src/repro/configs/qwen2_moe_a2_7b.py) at full
# width and depth; its decode-vs-prefill check runs at capacity factor 16,
# where no (token, choice) is dropped (the reference's
# test_moe_consistency_without_capacity_drops), and in float32 at depth 4
# (11.6 GB of weights); layer 0's MoE FFN is held on the card against the
# CPU on its first 512 tokens' inputs.
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CHECK_CAPACITY = 16.0
MOE_FP32_LAYERS = 4
MOE_LAYER0_TOKENS = 512
# Mamba2-1.3B: a prefill of 63 chunks of 128, 128 decode steps, and a fresh
# prefill of 8,192 positions (the reference takes multiples of the chunk).
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_PREFILL = 8064
MAMBA_TOKENS = 8192
# Whisper-tiny: 1,500 frame embeddings (30 s of audio, the encoder's own
# length), a 440-token prompt, and 8 decode steps to its 448-token context.
WHISPER_ARCH = "whisper-tiny"
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 440
WHISPER_CONTEXT = 448


@contextlib.contextmanager
def recorded_routing():
    """Record the expert ids (T, k) of every MoE routing call made inside
    the block, in call order (one call a layer and forward)."""
    from repro_torch.models import moe as MOE

    calls = []
    inner = MOE._routing

    def routing(p, s, x2d):
        out = inner(p, s, x2d)
        calls.append(out[0])
        return out

    MOE._routing = routing
    try:
        yield calls
    finally:
        MOE._routing = inner


@contextlib.contextmanager
def replayed_routing(forced: list):
    """Route the MoE calls made inside the block to ``forced``'s expert ids
    (T, k), one entry a call in order, each weighted by the call's own
    probabilities renormalized over them (aux loss 0): the forward the
    model computes had its router chosen those experts."""
    import torch

    from repro_torch.models import moe as MOE

    inner, it = MOE._routing, iter(forced)

    def routing(p, s, x2d):
        probs = torch.softmax(MOE.dense(p.router, x2d).float(), dim=-1)
        ids = next(it)
        w = torch.gather(probs, 1, ids)
        return ids, (w / w.sum(dim=-1, keepdim=True)).to(x2d.dtype), torch.zeros((), device=x2d.device)

    MOE._routing = routing
    try:
        yield
    finally:
        MOE._routing = inner


def moe_traffic(model, params, tokens, n_prefill: int, cache_len: int) -> dict:
    """The MoE model's traffic: ``family_traffic`` at the config's capacity
    factor (timed and counted, no check: a fresh prefill of another length
    groups and drops other tokens), then the same traffic at
    ``MOE_CHECK_CAPACITY`` (no drops) on the same parameters, its routing
    recorded, against a fresh prefill of all the tokens twice: as the model
    routes it (``decode_vs_prefill_rel_err``, with how many of the last
    token's (layer, choice) expert ids and of all (token, layer) rows
    differ from the traffic's), and with the traffic's expert choices
    replayed (``decode_vs_replayed_prefill_rel_err``), which takes out the
    bf16 router's flips of near-tied experts and leaves the caches and the
    decode path to the check."""
    import torch

    from repro_torch.models import build_model

    out = family_traffic(model, params, tokens, n_prefill, cache_len, check=False)
    del out["caches"], out["logits"]
    cf = MOE_CHECK_CAPACITY
    ref_model = build_model(dataclasses.replace(model.cfg, capacity_factor=cf), device=model.device)
    with recorded_routing() as calls:
        chk = family_traffic(ref_model, params, tokens, n_prefill, cache_len, check=False)
    n, steps = model.cfg.n_layers, tokens.shape[1] - n_prefill
    forced = [torch.cat([calls[i]] + [calls[n * (1 + t) + i] for t in range(steps)]) for i in range(n)]
    del calls
    with recorded_routing() as fresh:
        ref, _ = ref_model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    with replayed_routing(forced):
        replayed, _ = ref_model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    out.update(
        check_capacity_factor=cf, check_prefill_s=chk["prefill_s"],
        check_decode_ms_per_token=chk["decode_ms_per_token"],
        decode_vs_prefill_rel_err=rel_err(chk["logits"], ref),
        decode_vs_replayed_prefill_rel_err=rel_err(chk["logits"], replayed),
        last_token_expert_ids=sum(f[-1].numel() for f in forced),
        last_token_expert_ids_differ=sum(int((f[-1] != r[-1]).sum()) for f, r in zip(forced, fresh)),
        expert_id_rows=sum(f.shape[0] for f in forced),
        expert_id_rows_differ=sum(int((f != r).any(dim=1).sum()) for f, r in zip(forced, fresh)),
        caches=chk["caches"],
    )
    return out


def moe_layer0_input(params, cfg, tokens):
    """Layer 0's MoE input: ``norm2`` of the embedded tokens plus layer 0's
    attention (``mha`` as the prefill runs it)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    blk = params.blocks[0]
    b, s = tokens.shape
    with torch.no_grad():
        x = L.embed(params.embed, tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = x + L.mha(blk.attn, T._attn_spec(cfg, False), L.rms_norm(blk.norm1, x, cfg.norm_eps), positions)
        return L.rms_norm(blk.norm2, x, cfg.norm_eps)


def moe_drop_share(params, cfg, tokens) -> float:
    """The share of layer 0's (token, choice) pairs its capacity drops on
    ``tokens`` at the config's capacity factor."""
    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    spec = T._moe_spec(cfg)
    h = moe_layer0_input(params, cfg, tokens)
    with torch.no_grad():
        ids, _, _ = MOE._routing(params.blocks[0].moe, spec, h.reshape(-1, cfg.d_model))
        _, keep = MOE.dispatch_slots(spec, ids, MOE.group_size(spec, ids.shape[0]))
    return 1.0 - float(keep.float().mean())


def moe_layer0_check(params, cfg, tokens) -> dict:
    """Layer 0's ``moe_ffn`` on its own inputs for ``tokens``, with the
    layer's weights and the inputs cast to float32: on the parameters'
    device against the port on the CPU. Expert ids must be equal; returns
    them and the output's max abs and relative max error."""
    import copy

    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    spec = T._moe_spec(cfg)
    h = moe_layer0_input(params, cfg, tokens).float().reshape(-1, cfg.d_model)
    outs = []
    with torch.no_grad():
        for dev in (h.device, torch.device("cpu")):
            moe = copy.deepcopy(params.blocks[0].moe).to(device=dev, dtype=torch.float32)
            x = h.to(dev)
            ids, _, _ = MOE._routing(moe, spec, x)
            y, _ = MOE.moe_ffn(moe, spec, x[None])
            outs.append((ids.cpu(), y[0].cpu()))
            del moe, x
    (ids_a, y_a), (ids_b, y_b) = outs
    err = float((y_a - y_b).abs().max())
    return {"tokens": h.shape[0], "expert_ids_equal": bool(torch.equal(ids_a, ids_b)),
            "max_abs_err": err, "rel_err": err / (float(y_b.abs().max()) + 1e-6)}


def moe_prefill_flop(params, cfg, n: int) -> float:
    """The products a MoE prefill of n tokens does: attention projections,
    router and shared FFN (2 FLOP a parameter and token), the experts on
    their E x C capacity slots of every group, the one-hot dispatch and
    combine products (2 G g E C D each), and attention's visible pairs."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    spec = T._moe_spec(cfg)
    g = MOE.group_size(spec, n)
    slots = (n // g) * spec.n_experts * MOE.capacity(spec, g)
    blk = params.blocks[0]
    dense_params = sum(p.numel() for m in (blk.attn, blk.moe.router, blk.moe.shared) if m is not None
                       for p in m.parameters())
    experts = 2 * slots * 3 * cfg.d_model * cfg.expert_d_ff
    dispatch = 2 * 2 * slots * g * cfg.d_model
    attn = 4 * cfg.n_heads * cfg.resolved_head_dim * attention_pairs(n, n, True, 0)
    return cfg.n_layers * (2 * dense_params * n + experts + dispatch + attn)


def moe_phase(check: FlashCheck, gen) -> tuple[dict, dict]:
    """Phase 9, Qwen1.5-MoE-A2.7B: full width, all 24 layers, bf16,
    ``attn_impl="chunked"``, random weights from ``gen``. ``moe_traffic``
    at the prefill phase's size (24 flash launches a prefill, 0 a decode
    step; at capacity factor 16 the decode within 0.05 of the fresh prefill
    with the traffic's expert choices replayed, the plain error reported);
    its prefill profiled; layer 0's drop share at the config's capacity factor; layer
    0's MoE on the card against the CPU in float32; the flash kernel at
    layer 0's attention inputs. Then ``moe_traffic`` on the model in
    float32 at depth ``MOE_FP32_LAYERS``, both errors within 2e-4. Returns
    the ``family`` line and the kernel's entry for the ``kernels`` line."""
    import torch

    from repro_torch.configs import get_config

    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_impl="chunked")
    model, params, init_s = _model_on_card(cfg, gen)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_CACHE), generator=gen, device=model.device)
    torch.cuda.reset_peak_memory_stats()
    traffic = moe_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    peak = torch.cuda.max_memory_allocated()
    del traffic["caches"]
    check_family_traffic(MOE_ARCH, traffic, cfg.n_layers, 0, "bfloat16", "decode_vs_replayed_prefill_rel_err")
    prof, flash_ms = _prefill_profile(
        lambda: model.prefill(params, {"tokens": tokens[:, :PREFILL_TOKENS]}, cache_len=PREFILL_CACHE))
    _free()
    drop_share = moe_drop_share(params, cfg, tokens[:, :PREFILL_TOKENS])
    layer0 = moe_layer0_check(params, cfg, tokens[:, :MOE_LAYER0_TOKENS])
    _check(layer0["expert_ids_equal"] and layer0["rel_err"] < DECODE_REL_LIMIT["float32"],
           f"{MOE_ARCH}: layer 0's MoE on the card against the CPU in float32: {layer0}")
    q, k, v = layer0_qkv(params, cfg, tokens[:, :PREFILL_TOKENS])
    shape = f"{MOE_ARCH} q {tuple(q.shape)} k/v {tuple(k.shape)}, causal"
    entry = {shape: {**flash_entry(check, q, k, v, 0, shape), "launches_per_prefill": traffic["flash_launches"]["prefill"]}}
    del q, k, v
    line = {
        "model": f"{MOE_ARCH}, attn_impl chunked, {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "parameters": sum(p.numel() for p in params.parameters()), "init_s": init_s,
        "tokens": PREFILL_TOKENS, "cache_len": PREFILL_CACHE, "batch": 1,
        "capacity_factor": cfg.capacity_factor, "moe_group": cfg.moe_group, **traffic,
        "layer0_drop_share": drop_share, "layer0_moe_card_vs_cpu_float32": layer0,
        "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
        "prefill_floor_s": moe_prefill_flop(params, cfg, PREFILL_TOKENS) / BF16_FLOP_PER_S,
        # dense dispatch runs every expert on a decode step: all weights read
        "decode_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "profile_prefill": prof, "prefill_flash_device_ms": flash_ms,
        "prefill_flash_share": None if not prof["device_ms"] else flash_ms / prof["device_ms"],
    }
    del model, params, traffic
    _free()

    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, n_layers=MOE_FP32_LAYERS)
    model, params, _ = _model_on_card(cfg32, gen)
    traffic = moe_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    del traffic["caches"], model, params, tokens
    check_family_traffic(MOE_ARCH, traffic, MOE_FP32_LAYERS, 0, "float32")
    check_family_traffic(MOE_ARCH, traffic, MOE_FP32_LAYERS, 0, "float32", "decode_vs_replayed_prefill_rel_err")
    line["float32"] = {"layers": MOE_FP32_LAYERS, **traffic}
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line, entry


def mamba_prefill_flop(params, cfg, n: int) -> float:
    """A Mamba-2 prefill's products: 2 FLOP a block parameter and position,
    and the SSD's per chunk: C.B (2 Q^2 N), the within-chunk mix (2 Q^2 H
    P), the chunk states and their read-out (2 x 2 Q N H P)."""
    from repro_torch.models import transformer as T

    s = T._mamba_spec(cfg)
    q, h, hp, st = s.chunk, s.n_heads, s.head_dim, s.d_state
    ssd = (n // q) * (2 * q * q * st + 2 * q * q * h * hp + 4 * q * st * h * hp)
    return 2 * sum(p.numel() for p in params.blocks.parameters()) * n + cfg.n_layers * ssd


def mamba_phase(gen) -> dict:
    """Phase 9, Mamba2-1.3B: full width, all 48 layers, bf16, random
    weights from ``gen``. ``family_traffic``: prefill ``MAMBA_PREFILL``
    positions, decode to ``MAMBA_TOKENS``, against a fresh prefill (no
    flash launch; the bf16 error reported); the prefill profiled. Then the
    same traffic in float32, held within 2e-4. Returns the ``family``
    line."""
    import torch

    from repro_torch.configs import get_config

    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = get_config(MAMBA_ARCH)
    model, params, init_s = _model_on_card(cfg, gen)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab, (1, MAMBA_TOKENS), generator=gen, device=model.device)
    torch.cuda.reset_peak_memory_stats()
    traffic = family_traffic(model, params, tokens, MAMBA_PREFILL, MAMBA_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    del traffic["caches"], traffic["logits"]
    # bf16: reported, not held to a limit (48 layers and 128 steps of bf16
    # rounding put it at 0.05-0.07 by seed, PERF.md 6); float32 is the check
    check_family_traffic(MAMBA_ARCH, traffic, 0, 0, "bfloat16", None)
    prof, flash_ms = _prefill_profile(lambda: model.prefill(params, {"tokens": tokens[:, :MAMBA_PREFILL]}))
    line = {
        "model": f"{MAMBA_ARCH}, {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "parameters": sum(p.numel() for p in params.parameters()), "init_s": init_s,
        "tokens": MAMBA_PREFILL, "decode_to": MAMBA_TOKENS, "batch": 1, "chunk": cfg.ssm_chunk, **traffic,
        "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
        "prefill_floor_s": mamba_prefill_flop(params, cfg, MAMBA_PREFILL) / BF16_FLOP_PER_S,
        "decode_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "profile_prefill": prof, "prefill_flash_device_ms": flash_ms,
    }
    del model, params, traffic
    _free()

    model, params, _ = _model_on_card(dataclasses.replace(cfg, param_dtype=torch.float32), gen)
    traffic = family_traffic(model, params, tokens, MAMBA_PREFILL, MAMBA_TOKENS)
    del traffic["caches"], traffic["logits"], model, params, tokens
    check_family_traffic(MAMBA_ARCH, traffic, 0, 0, "float32")
    line["float32"] = traffic
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line


def whisper_prefill_flop(params, cfg, n_enc: int, n_dec: int) -> float:
    """An enc-dec prefill's products: the encoder's blocks on n_enc frames,
    the decoder's on n_dec tokens (its cross K/V projections on the n_enc
    frames), the unembedding of the n_dec tokens, and attention's visible
    pairs (encoder n_enc^2, causal decoder, cross n_dec x n_enc)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    enc = sum(p.numel() for p in params.enc_blocks.parameters())
    dec = sum(p.numel() for p in params.dec_blocks.parameters())
    cross_kv = cfg.n_layers * 2 * d * cfg.n_kv_heads * hd
    products = 2 * (enc * n_enc + (dec - cross_kv) * n_dec + cross_kv * n_enc + params.embed.table.numel() * n_dec)
    pairs = cfg.n_enc_layers * n_enc * n_enc + cfg.n_layers * (attention_pairs(n_dec, n_dec, True, 0) + n_dec * n_enc)
    return products + 4 * cfg.n_heads * hd * pairs


def whisper_phase(gen) -> dict:
    """Phase 9, Whisper-tiny: all 4 + 4 layers, bf16, random weights and
    frame embeddings from ``gen``. ``family_traffic`` with the frames:
    prefill ``WHISPER_PROMPT`` tokens, self caches padded to
    ``WHISPER_CONTEXT``, decode to it, held against a fresh prefill of the
    whole context (within 0.05; no flash launch); the prefill profiled.
    Then the same traffic in float32 (within 2e-4). Returns the ``family``
    line."""
    import torch

    from repro_torch.configs import get_config

    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = get_config(WHISPER_ARCH)
    model, params, init_s = _model_on_card(cfg, gen)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    frames = torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=gen, device=model.device)
    tokens = torch.randint(0, cfg.vocab, (1, WHISPER_CONTEXT), generator=gen, device=model.device)
    torch.cuda.reset_peak_memory_stats()
    traffic = family_traffic(model, params, tokens, WHISPER_PROMPT, 0, frames=frames.to(cfg.param_dtype))
    peak = torch.cuda.max_memory_allocated()
    del traffic["caches"], traffic["logits"]
    check_family_traffic(WHISPER_ARCH, traffic, 0, 0, "bfloat16")
    batch = {"tokens": tokens[:, :WHISPER_PROMPT], "frame_embeds": frames.to(cfg.param_dtype)}
    prof, flash_ms = _prefill_profile(lambda: model.prefill(params, batch))
    cross_bytes = 2 * cfg.n_layers * WHISPER_FRAMES * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    line = {
        "model": f"{WHISPER_ARCH}, {cfg.n_enc_layers} + {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "parameters": sum(p.numel() for p in params.parameters()), "init_s": init_s,
        "frames": WHISPER_FRAMES, "tokens": WHISPER_PROMPT, "decode_to": WHISPER_CONTEXT, "batch": 1, **traffic,
        "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
        "prefill_floor_s": whisper_prefill_flop(params, cfg, WHISPER_FRAMES, WHISPER_PROMPT) / BF16_FLOP_PER_S,
        # a decode step reads every weight and the cross caches once
        "decode_floor_ms": (weight_bytes + cross_bytes) / HBM_BYTES_PER_S * 1e3,
        "profile_prefill": prof, "prefill_flash_device_ms": flash_ms,
    }
    del model, params, traffic, batch
    _free()

    model, params, _ = _model_on_card(dataclasses.replace(cfg, param_dtype=torch.float32), gen)
    traffic = family_traffic(model, params, tokens, WHISPER_PROMPT, 0, frames=frames)
    del traffic["caches"], traffic["logits"], model, params, tokens, frames
    check_family_traffic(WHISPER_ARCH, traffic, 0, 0, "float32")
    line["float32"] = traffic
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line


# Phase 10: MiniCPM3-4B (src/repro/configs/minicpm3_4b.py, HF
# openbmb/MiniCPM3-4B), multi-head latent attention at full width and depth.
MLA_ARCH = "minicpm3-4b"


def mla_layer0_qkv(params, cfg, tokens):
    """Layer 0's flash inputs at the prefill's shape, as ``mla_prefill``
    makes them from the embedded tokens: q (B, S, H, qk) of the nope and
    rope queries, k (B, S, H, qk) of the expanded nope keys and the shared
    rope key, v (B, S, H, v_head_dim)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import transformer as T

    blk, s = params.blocks[0], T._mla_spec(cfg)
    b, sl = tokens.shape
    with torch.no_grad():
        h = L.rms_norm(blk.norm1, L.embed(params.embed, tokens), cfg.norm_eps)
        positions = torch.arange(sl, device=tokens.device).expand(b, sl)
        c_kv, k_rope = MLA._latents(blk.attn, s, h, positions)
        q_nope, q_rope = MLA._queries(blk.attn, s, h, positions)
        k_nope = L.dense(blk.attn.w_uk, c_kv).reshape(b, sl, s.n_heads, s.qk_nope_head_dim)
        v = L.dense(blk.attn.w_uv, c_kv).reshape(b, sl, s.n_heads, s.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, sl, s.n_heads, s.qk_rope_head_dim)], dim=-1)
    return q, k, v


def mla_phase(check: FlashCheck, gen) -> tuple[dict, dict]:
    """Phase 10, MiniCPM3-4B: full width, all 62 layers, bf16,
    ``attn_impl="chunked"``, random weights from ``gen``. ``family_traffic``
    at the prefill phase's size (62 flash launches a prefill at head dims
    (96, 64), 0 a decode step, the absorbed decode within 0.05 of the fresh
    prefill); its prefill profiled; the flash kernel at layer 0's inputs.
    Then the same traffic on the model in float32, within 2e-4. Returns the
    ``family`` line and the kernel's entry for the ``kernels`` line."""
    import torch

    from repro_torch.configs import get_config

    _warm_cublas()
    _free()
    mem_before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(MLA_ARCH), attn_impl="chunked")
    model, params, init_s = _model_on_card(cfg, gen)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_CACHE), generator=gen, device=model.device)
    torch.cuda.reset_peak_memory_stats()
    traffic = family_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    peak = torch.cuda.max_memory_allocated()
    check_family_traffic(MLA_ARCH, traffic, cfg.n_layers, 0, "bfloat16")
    caches = traffic.pop("caches")[0][0]
    shapes = {n: tuple(t.shape) for n, t in caches.items()}
    _check(shapes == {"ckv": (cfg.n_layers, 1, PREFILL_CACHE, cfg.kv_lora_rank),
                      "kr": (cfg.n_layers, 1, PREFILL_CACHE, cfg.qk_rope_head_dim)},
           f"{MLA_ARCH}: latent caches {shapes}")
    del traffic["logits"], caches
    prof, flash_ms = _prefill_profile(
        lambda: model.prefill(params, {"tokens": tokens[:, :PREFILL_TOKENS]}, cache_len=PREFILL_CACHE))
    _free()
    q, k, v = mla_layer0_qkv(params, cfg, tokens[:, :PREFILL_TOKENS])
    shape = f"{MLA_ARCH} q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}, causal"
    entry = {shape: {**flash_entry(check, q, k, v, 0, shape),
                     "launches_per_prefill": traffic["flash_launches"]["prefill"]}}
    del q, k, v
    layer_params = sum(p.numel() for p in params.blocks.parameters())
    qk, vd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    attn_flop = cfg.n_layers * 2 * (qk + vd) * cfg.n_heads * attention_pairs(PREFILL_TOKENS, PREFILL_TOKENS, True, 0)
    line = {
        "model": f"{MLA_ARCH}, attn_impl chunked, {cfg.n_layers} layers, {cfg.param_dtype}, random weights",
        "parameters": sum(p.numel() for p in params.parameters()), "init_s": init_s,
        "tokens": PREFILL_TOKENS, "cache_len": PREFILL_CACHE, "batch": 1,
        "head_dims": {"qk": qk, "v": vd}, **traffic, "latent_cache_shapes": shapes,
        "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
        "prefill_floor_s": (2 * layer_params * PREFILL_TOKENS + attn_flop) / BF16_FLOP_PER_S,
        # a decode step reads every weight once, the tied embedding included
        "decode_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "profile_prefill": prof, "prefill_flash_device_ms": flash_ms,
        "prefill_flash_share": None if not prof["device_ms"] else flash_ms / prof["device_ms"],
    }
    del model, params, traffic
    _free()

    model, params, _ = _model_on_card(dataclasses.replace(cfg, param_dtype=torch.float32), gen)
    traffic = family_traffic(model, params, tokens, PREFILL_TOKENS, PREFILL_CACHE)
    del traffic["caches"], traffic["logits"], model, params, tokens
    check_family_traffic(MLA_ARCH, traffic, cfg.n_layers, 0, "float32")
    line["float32"] = traffic
    _free()
    line["left_allocated_bytes"] = torch.cuda.memory_allocated() - mem_before
    return line, entry


# Phase 11a: the dry runs, host passes as the reference's are (the cells'
# records go to results/dryrun/).
DRYRUN_CELLS = (("train", "train_4k"), ("serve", "decode_32k"))


@contextlib.contextmanager
def one_by_one_mesh():
    """A world-1 NCCL process group on a ``HashStore`` (no port is opened)
    and a (1, 1) ("data", "model") mesh over the card; torn down on exit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def mesh_prefill_phase(model, params, mesh, gen) -> dict:
    """Phase 11b: phase 6's model on the (1, 1) mesh. Its parameters are
    wrapped as DTensors at ``rules_for(mesh, prefill_32k)``'s placements and
    8,192 tokens, placed by ``batch_shardings``, are prefilled under the
    rules: the logits and every layer's k/v cache must be bitwise the
    unsharded prefill's on the same tokens, with one flash launch a layer.
    Both are timed and profiled. Returns the ``mesh_prefill`` line."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import place_module, placements, unplace_module, use_sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.launch import specs as SP

    cfg, dev = model.cfg, model.device
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_TOKENS), generator=gen, device=dev)
    rules = SP.rules_for(mesh, SHAPES["prefill_32k"])
    spec = SP.batch_shardings(mesh, rules, {"tokens": tokens})["tokens"].spec
    placed_tokens = DTensor.from_local(tokens, mesh, placements(spec, mesh), run_check=False)

    def plain_prefill():
        return model.prefill(params, {"tokens": tokens}, cache_len=PREFILL_CACHE)

    def mesh_prefill():
        with use_sharding_rules(rules):
            return model.prefill(params, {"tokens": placed_tokens}, cache_len=PREFILL_CACHE)

    torch.cuda.synchronize()
    t = time.perf_counter()
    want, want_caches = plain_prefill()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t
    prof_plain = device_profile(plain_prefill)
    torch.cuda.empty_cache()
    plain = place_module(params, mesh, rules, lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False))
    try:
        flash_attention_cuda.launches = 0
        for kind in ops.launch_counts:
            ops.launch_counts[kind] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, caches = mesh_prefill()
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t
        launches = flash_attention_cuda.launches
        _check(launches == cfg.n_layers, f"the mesh prefill launched the flash kernel {launches} times")
        _check(isinstance(got, DTensor), "the mesh prefill's logits are no DTensor")
        _check(torch.equal(_bits(got.to_local()), _bits(want)), "the mesh prefill's logits differ from the unsharded")
        for name in ("k", "v"):
            _check(torch.equal(_bits(caches[0][0][name].to_local()), _bits(want_caches[0][0][name])),
                   f"the mesh prefill's {name} caches differ from the unsharded")
        placements_seen = {
            "logits": [str(p) for p in got.placements],
            "k_cache": [str(p) for p in caches[0][0]["k"].placements],
            "wq.w": [str(p) for p in params.blocks[0].attn.wq.w.placements],
        }
        del got, caches, want_caches
        torch.cuda.empty_cache()
        prof_mesh = device_profile(mesh_prefill)
        torch.cuda.empty_cache()
    finally:
        unplace_module(params, plain)
    return {
        "model": f"{cfg.arch_id}, attn_impl {cfg.attn_impl}, {cfg.n_layers} layers, {cfg.param_dtype}",
        "mesh": "(1, 1) (data, model), NCCL world 1", "rules": "rules_for(mesh, prefill_32k)",
        "tokens": PREFILL_TOKENS, "cache_len": PREFILL_CACHE, "placements": placements_seen,
        "flash_launches": launches, "logits_and_caches_bitwise_equal": True,
        "prefill_s": {"plain": t_plain, "mesh": t_mesh},
        "profile_plain": prof_plain, "profile_mesh": prof_mesh,
    }


def mesh_save_phase(seed: int, mesh, rows: list[dict]) -> dict:
    """Phase 11c: phase 3's layer (made again from ``seed``) saved plainly,
    then again with its leaves wrapped as DTensors on the (1, 1) mesh at the
    placements the train rules give them: every leaf ref-only, 0 bytes
    sent, the manifest a plain re-save writes, one cut and one fingerprint
    launch, each kernel then held against its twin on that wave. Adds the
    path to ``rows``' ``launches_by_path`` and its comparisons to their
    counts. Returns the ``mesh_save`` line."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import ChunkingSpec, DedupCluster
    from repro_torch.distributed.sharding import infer_param_spec, map_with_path, placements
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdc import cdc_cut_positions_cuda
    from repro_torch.kernels.fingerprint import fingerprint_chunks_cuda
    from repro_torch.launch import specs as SP

    dev = torch.device("cuda")
    cuda_gen = torch.Generator(device=dev).manual_seed(seed)
    tree = materialize(decoder_layer_shapes(**QWEN2_5_32B),
                       lambda s: torch.randn(s, generator=cuda_gen, device=dev, dtype=torch.bfloat16))
    cluster = DedupCluster.create(4, replicas=2, chunking=ChunkingSpec("fixed", 512 * 1024))
    ckpt = DedupCheckpointer(cluster, CheckpointConfig())
    t = time.perf_counter()
    m1 = ckpt.save("plain", tree)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t
    sent = ckpt.stats["bytes_sent"]
    rules = SP.rules_for(mesh, SHAPES["train_4k"])
    dtree = map_with_path(lambda keys, leaf: DTensor.from_local(
        leaf, mesh, placements(infer_param_spec(keys, tuple(leaf.shape), rules), mesh), run_check=False), tree)
    kernels = (cdc_cut_positions_cuda, fingerprint_chunks_cuda)
    for k in kernels:
        k.launches = 0
    for kind in ops.launch_counts:
        ops.launch_counts[kind] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    m2 = ckpt.save("mesh", dtree)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in kernels}
    _check(launches == {"cdc_cut_positions_cuda": 1, "fingerprint_chunks_cuda": 1}, f"mesh save launches {launches}")
    want = {"name": "mesh", "leaves": [{"key": e["key"], "object": f"ckpt/mesh/{e['key']}", "ref": True}
                                       for e in m1["leaves"]]}
    _check(m2 == want, "the mesh save's manifest is not a plain identical re-save's")
    _check(ckpt.stats["bytes_sent"] == sent, f"the mesh save sent {ckpt.stats['bytes_sent'] - sent} B")

    # the two kernels against their twins on the wave the mesh save made
    check = TwinCheck()
    leaves = []
    map_with_path(lambda _, leaf: leaves.append(leaf), dtree)
    streams = [ops.tensor_to_u8(leaf.full_tensor()) for leaf in leaves]
    kw = ckpt.spec.kernel_kwargs()
    check.cuts(streams, kw, "cut-positions kernel on the mesh save's wave")
    wave_rows, _ = ops.cut_wave_rows(streams, **kw)
    check.fingerprints(wave_rows, fingerprint_chunks_cuda(wave_rows), "fingerprint kernel on the mesh save's wave")
    torch.cuda.synchronize()
    for row in rows:
        kind = {"cdc_cut_positions_cuda": "cdc_cut", "fingerprint_chunks_cuda": "fingerprint"}.get(row["name"])
        if kind:
            row["launches_by_path"]["mesh save"] = launches[row["name"]]
            row["mismatches"] += check.mismatches[kind]
            row["max_abs_err"] = max(row["max_abs_err"], check.err[kind])
            row["mesh_wave"] = {"mismatches": check.mismatches[kind], "max_abs_err": check.err[kind]}
    return {
        "tree": "Qwen2.5-32B decoder layer, bf16, leaves as DTensors at rules_for(mesh, train_4k)",
        "leaves": len(m2["leaves"]), "ref_only": sum(e["ref"] for e in m2["leaves"]),
        "bytes_sent": ckpt.stats["bytes_sent"] - sent, "kernel_launches": launches,
        "save_s": {"plain_s1": t_plain, "mesh_resave": t_mesh},
        "twin_mismatches": {"cdc_cut": check.mismatches["cdc_cut"], "fingerprint": check.mismatches["fingerprint"]},
    }


def start_dry_runs() -> list[tuple]:
    """Phase 11a: ``repro_torch.launch.train --dryrun`` at train_4k and
    ``repro_torch.launch.serve --dryrun`` at decode_32k for Qwen2.5-32B on
    the (16, 16) production mesh, side by side, each a host process that
    sees no card. Started before the build, they run beside it; a thread
    notes the moment each ends, and each is killed if the script ends
    first."""
    import os
    import tempfile
    import threading

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    runs = []
    for launcher, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--dryrun", "--arch", "qwen2.5-32b",
               "--shape", shape]
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
        atexit.register(proc.kill)
        ended: list[float] = []
        waiter = threading.Thread(target=lambda p=proc, e=ended: (p.wait(), e.append(time.perf_counter())),
                                  daemon=True)
        waiter.start()
        runs.append((shape, t0, proc, waiter, ended, out, err))
    return runs


def dry_run_records(runs: list[tuple]) -> list[dict]:
    """Phase 11a's records, with each process's seconds; each must read
    ``status: ok``."""
    recs = []
    for shape, t0, proc, waiter, ended, out, err in runs:
        waiter.join(timeout=600)
        _check(not waiter.is_alive(), f"the {shape} dry run did not end")
        seconds = ended[0] - t0
        out.seek(0)
        err.seek(0)
        _check(proc.returncode == 0, f"the {shape} dry run exited {proc.returncode}: {err.read()[-2000:]}")
        rec = json.loads((ROOT / "results" / "dryrun" / f"qwen2.5-32b__{shape}__pod16x16.json").read_text())
        rec["seconds"] = seconds
        rec["line"] = out.read().strip().splitlines()[-2]
        _check(rec["status"] == "ok", f"the {shape} dry run's record reads {rec['status']}: {rec.get('error')}")
        recs.append(rec)
    return recs


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

    dry_runs = start_dry_runs()
    phases = {}
    t_start = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

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

    phase_done("1 build")
    rows_out = dedup_phases(args.seed, fp_ops_per_word, fp_issued_per_word)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("2-4 dedup kernels and checkpoint path")

    # ------------- 4b-4d. the train path at full width, three families
    # ``launches`` stays the checkpoint path's count, as the row's other
    # numbers are of its wave; each train path's count and its wave's
    # numbers ride beside them.
    train_lines = {}
    for row in rows_out:
        row["launches_by_path"] = {"checkpoint": row["launches"]}
    for name, arch, published, layers, traffic in TRAIN_PHASES:
        line = train_lines[arch] = train_phase(arch, published, layers, args.seed, fp_ops_per_word, traffic)
        print(("train " if traffic is train_traffic else "train_family ") + json.dumps(line))
        _check(line["left_allocated_bytes"] == 0, f"the {arch} train phase left {line['left_allocated_bytes']} B")
        for row in rows_out:
            row["launches_by_path"][f"{arch} train"] = line["kernel_launches"][row["name"]]
            if row["name"] in line["kernel_wave"]:
                row.setdefault("train_wave_by_arch", {})[arch] = line["kernel_wave"][row["name"]]
        phase_done(name)

    # ---- 4e. the train path through the flash kernels, forward and backward
    chunked = chunked_train_phase(args.seed)
    print("train_chunked " + json.dumps(chunked))
    _check(chunked["left_allocated_bytes"] == 0, f"phase 4e left {chunked['left_allocated_bytes']} B")
    phase_done("4e train through the flash kernels, LLaVA-NeXT")

    # ------------------- 4f. the AdamW kernels at the benchmark's leaf set
    adamw_out = adamw_phase(TRAIN_ARCH, ADAMW_LAYERS, args.seed)
    _check(adamw_out.pop("left_allocated_bytes") == 0, "phase 4f left memory allocated on the card")
    adamw_out["launches_by_path"] = {f"{arch} train": line["optimizer_launches"] for arch, line in train_lines.items()}
    adamw_out["launches_by_path"][f"{TRAIN_ARCH} train, chunked (4e), {CHUNKED_STEPS} chunked and 1 dense steps"] = \
        chunked["optimizer_launches"]
    print("adamw " + json.dumps(adamw_out))
    phase_done("4f AdamW kernels, LLaVA-NeXT at 8 layers")

    # --------------------------------------- 5. flash kernel vs plain version
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    check = FlashCheck()
    flash_grid_phase(check, gen)
    print("flash vs plain: " + json.dumps({"cases": check.cases, "mismatches": check.mismatches,
                                           "max_abs_err": check.max_abs_err,
                                           "max_err_ratio": check.max_err_ratio, "rtol": FLASH_RTOL}))
    bwd_row = flash_bwd_phase(gen)
    bwd_row["launches"] = sum(r["flash_launches"]["backward"] for r in chunked["steps"])
    bwd_row["launches_by_path"] = {f"{TRAIN_ARCH} train, chunked (4e), {CHUNKED_STEPS} steps": bwd_row["launches"],
                                   f"{TRAIN_ARCH} float32 depth 1, one step": 1}
    print("flash backward vs plain: " + json.dumps({k: bwd_row[k] for k in (
        "cases", "mismatches", "lse_mismatches", "max_abs_err_by_dtype", "max_err_ratio", "max_lse_err", "rtol")}))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("5 flash grid, forward and backward")

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

    # ---------- 11b, 11c. the (1, 1) mesh: a prefill and a checkpoint save
    t11 = time.perf_counter()
    with one_by_one_mesh() as mesh:
        mesh_prefill = mesh_prefill_phase(model, params, mesh, gen)
        print("mesh_prefill " + json.dumps(mesh_prefill))
        print("mesh_save " + json.dumps(mesh_save_phase(args.seed, mesh, rows_out)))
    t11 = time.perf_counter() - t11
    flash_mesh_launches = mesh_prefill["flash_launches"]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("6, 7, 11b, 11c Qwen2.5-32B prefill, serving, mesh")

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
    phase_done("8 sliding-window families")

    # ------------------- 9. MoE, Mamba-2 and enc-dec at full width
    line, flash_row["moe"] = moe_phase(check, gen)
    print("family " + json.dumps(line))
    flash_row["launches_by_path"][f"{MOE_ARCH} prefill"] = line["flash_launches"]["prefill"]
    lines = [line, mamba_phase(gen), whisper_phase(gen)]
    for line in lines[1:]:
        print("family " + json.dumps(line))
    for line in lines:
        _check(line["left_allocated_bytes"] == 0, f"{line['model']} left {line['left_allocated_bytes']} B on the card")
    phase_done("9 MoE, Mamba2, Whisper")

    # ------------------- 10. multi-head latent attention at full width
    line, flash_row["mla"] = mla_phase(check, gen)
    print("family " + json.dumps(line))
    _check(line["left_allocated_bytes"] == 0, f"{line['model']} left {line['left_allocated_bytes']} B on the card")
    flash_row["launches_by_path"][f"{MLA_ARCH} prefill"] = line["flash_launches"]["prefill"]
    flash_row["launches_by_path"]["qwen2.5-32b prefill on a (1, 1) mesh"] = flash_mesh_launches
    for arch, line in train_lines.items():
        flash_row["launches_by_path"][f"{arch} train"] = line["kernel_launches"]["flash_attention_cuda"]
    flash_row["launches_by_path"][f"{TRAIN_ARCH} train, chunked (4e), {CHUNKED_STEPS} steps"] = sum(
        r["flash_launches"]["forward"] for r in chunked["steps"])
    phase_done("10 MiniCPM3-4B")

    # ------------------------------- 11a. the dry runs (host passes)
    t = time.perf_counter()
    for rec in dry_run_records(dry_runs):
        print("dryrun " + json.dumps(rec))
    t11 += time.perf_counter() - t
    print(f"phase 11: {t11:.3f} s (11b and 11c on the card, and the wait for 11a's dry runs, "
          "which ran on the host beside the build)")
    phase_done("11a dry runs (the wait)")
    phases["total"] = time.perf_counter() - t_start
    print("phases " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    flash_row.update(mismatches=check.mismatches, cases=check.cases, max_abs_err=max(check.max_abs_err.values()),
                     max_abs_err_by_dtype=check.max_abs_err, max_err_ratio=check.max_err_ratio)
    rows_out += [flash_row, bwd_row, adamw_out]
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
