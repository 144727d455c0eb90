"""The reference's training steps: gradients of the plain model's loss,
summed over microbatches, and AdamW with float32 state, written from
Loshchilov and Hutter (arXiv 1711.05101) with the job's global-norm
clipping and its warmup-cosine learning rate. It follows the first steps
of a job from the same weights and batches the program was given, and
reads what the comparison needs: each step's loss, the first gradient's
global norm and each leaf's norm after clipping, and each leaf's change
after the last step.
"""

from __future__ import annotations

import math

import torch


def leaf_names(tree: dict, path: str = "") -> list[tuple[str, tuple]]:
    """(name, key path) of every leaf of a JAX-layout tree, block leaves
    once per layer: ``blocks.{g}.attn.wq.w`` for layer g of a stacked leaf,
    as ``nn.Module.named_parameters`` spells them."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k == "blocks":
            for i, stack in enumerate(v):
                n = next(iter(_leaves(stack))).shape[0]
                for g in range(n):
                    for sub, keys in _paths(stack):
                        out.append((f"blocks.{g * len(v) + i}.{sub}", ("blocks", i, *keys, g)))
        elif k == "tail":
            continue
        elif isinstance(v, dict):
            for sub, keys in _paths(v):
                out.append((f"{k}.{sub}", (k, *keys)))
    return out


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _paths(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            for sub, keys in _paths(v):
                yield f"{k}.{sub}", (k, *keys)
        else:
            yield k, (k,)


def get(tree, keys: tuple) -> torch.Tensor:
    for k in keys:
        tree = tree[k]
    return tree


def map_tree(fn, tree):
    """``fn`` of every leaf, visited in ``flat``'s order."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def flat(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in flat(v)]
    return [tree]


def learning_rate(opt: dict, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then cosine decay to a tenth of
    ``lr`` at ``total_steps``; ``step`` counts from 1."""
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def follow(params: dict, model: dict, opt: dict, batches: list[list[dict]], loss_fn) -> dict:
    """Train ``params`` (a float32 tree, updated in place) on the family's
    ``loss_fn(params, model, microbatch)`` through one step per entry of
    ``batches`` (each a list of microbatches) and read: the
    steps' losses, the first step's gradient norm before clipping, each
    leaf's norm of the first clipped gradient, each leaf's change over all
    the steps. Leaves are named as ``leaf_names`` names them."""
    leaves = flat(params)
    start = [t.detach().to("cpu", copy=True) for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    names = leaf_names(params)
    out = {"losses": []}
    for step, micro in enumerate(batches, start=1):
        total = 0.0
        for t in leaves:
            t.requires_grad_(True)
        for mb in micro:
            loss = loss_fn(params, model, mb)
            loss.backward()  # summed into each leaf's .grad
            total += float(loss.detach())
        grads = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        for g in grads:
            g.div_(len(micro))
        out["losses"].append(total / len(micro))
        gnorm = math.sqrt(sum(float((g.double() * g.double()).sum()) for g in grads) + 1e-16)
        clip = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
        lr = learning_rate(opt, step)
        b1c, b2c = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
        if step == 1:
            out["grad_norm"] = gnorm
            tree = _as_tree(grads, params)
            out["grad_leaf_norms"] = {name: float(get(tree, keys).norm()) * clip for name, keys in names}
        with torch.no_grad():
            for t, g, m, v in zip(leaves, grads, mu, nu):
                g.mul_(clip)
                m.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                t.sub_(lr * ((m / b1c) / ((v / b2c).sqrt() + opt["eps"]) + opt["weight_decay"] * t))
        del grads
    # each leaf's change from its host copy, one leaf at a time
    where = _as_tree(list(range(len(leaves))), params)
    by_leaf: dict[int, list] = {}
    for name, keys in names:
        node, i = where, 0
        while not isinstance(node, int):
            node, i = node[keys[i]], i + 1
        by_leaf.setdefault(node, []).append((name, keys[i:]))
    out["change_leaf_norms"] = {}
    for j, t in enumerate(leaves):
        change = t - start[j].to(t.device)
        for name, rest in by_leaf.get(j, []):
            out["change_leaf_norms"][name] = float(get(change, rest).norm())
        del change
    return out


def _as_tree(values: list[torch.Tensor], like):
    """``values`` (in ``flat(like)``'s order) laid out as ``like``."""
    it = iter(values)
    return map_tree(lambda _: next(it), like)
