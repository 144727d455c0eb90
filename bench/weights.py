"""The benchmark's own inputs, made from ``--seed`` on the device: the
weights of a configuration (a JAX-layout tree, the form the program's
``params_from_numpy`` and the plain reference both take) and each step's
batch. Both sides are handed the same values; nothing here imports the
program.

Weights: the leaves and their order are the family's ``layout(m)``
(``bench/families/<family>.py``). Every normally drawn leaf is a view of
one flat buffer in the configuration's dtype, filled by one ``normal_``
call of a generator on the device and scaled per leaf (dense weights
1/sqrt(d_in), the embedding 0.02); norm scales are 1, biases 0, and the
kinds "a_log" and "f32:<value>" float32 constants (log(1..16) spread over
the last axis, and the value).
"""

from __future__ import annotations

import hashlib
import math

import torch

from bench.families import family as _family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The batches' statistics: the share of text positions that continue their
# predecessor + 1, and the standard deviation of the vision stub's patches.
FOLLOW_SHARE = 0.5
PATCH_STD = 1.0


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (a weight buffer, a step's batch)."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def padded_vocab(m: dict) -> int:
    """The embedding's rows as the program holds them: the vocabulary padded
    to a multiple of 256 (the padding rows carry no probability)."""
    return -(-m["vocab"] // 256) * 256


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        if isinstance(k, int):
            while len(tree) <= k:
                tree.append({})
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if k == "blocks" else {})
    tree[path[-1]] = value


def make_tree(m: dict, family: str, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The weights of configuration ``m`` of ``family`` drawn from ``seed``
    on ``device`` in ``dtype`` (the configuration's own by default). Block
    leaves are stacked on a leading layer axis; ``blocks`` is a tuple of the
    stacks the layout names, the tail empty. A layout's kind is "normal"
    (drawn, times its scale), "ones", "zeros", "a_log" or "f32:<value>"."""
    dtype = dtype or DTYPES[m["dtype"]]
    spec = _family(family).layout(m)
    sizes = [math.prod(shape) for _, shape, kind, _ in spec if kind == "normal"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.empty((sum(sizes),), dtype=dtype, device=device).normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, shape, kind, scale in spec:
        if kind == "normal":
            n = math.prod(shape)
            t = flat[off : off + n].view(shape).mul_(scale)
            off += n
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "a_log":
            t = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device)).expand(shape)
            t = t.contiguous()
        else:
            t = torch.full(shape, float(kind.split(":")[1]), dtype=torch.float32, device=device)
        _put(tree, path, t)
    tree["blocks"] = tuple(tree["blocks"])
    tree["tail"] = ()
    return tree


def make_batch(m: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s global batch: ``tokens`` and ``labels`` (B, S_text)
    int32 over the vocabulary, the labels each next token; a share
    ``FOLLOW_SHARE`` of positions continue their predecessor + 1 (a rule a
    model can learn); with a vision stub, ``patch_embeds`` (B, n_front, D)
    drawn with standard deviation ``PATCH_STD`` in the model's dtype."""
    b, s, n_front = m["global_batch"], m["seq_len"], m.get("n_frontend_tokens", 0)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", step))
    toks = torch.randint(0, m["vocab"], (b, s - n_front + 1), generator=gen, device=device)
    follow = torch.rand((b, s - n_front), generator=gen, device=device) < FOLLOW_SHARE
    toks[:, 1:] = torch.where(follow, (toks[:, :-1] + 1) % m["vocab"], toks[:, 1:])
    out = {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}
    if n_front:
        out["patch_embeds"] = torch.empty((b, n_front, m["d_model"]), dtype=DTYPES[m["dtype"]],
                                          device=device).normal_(0.0, PATCH_STD, generator=gen)
    return out


def microbatches(batch: dict, accum: int) -> list[dict]:
    """The global batch split into ``accum`` runs of consecutive rows, as
    the trainer splits it."""
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(accum)]
