"""Training loop: an eager train step with grad accumulation, AdamW, and
dedup-checkpointing hooks.

A port of the JAX package's ``train/loop.py``.
build_train_step(model, opt_cfg, accum=N) returns
    train_step(state, batch) -> (state, metrics)
where state = {"params": DecoderLM, "opt": adamw state}. With accum > 1 the
global batch is split into N microbatches run one after another; their
grads are summed in fp32 buffers and divided by N, as the reference's scan
does. Grads come from ``torch.autograd.grad``, so no ``.grad`` is ever set
and they are freed when the step returns, before any checkpoint hook runs.
The step updates the parameters and the optimizer state in place.

The step pauses Python's cyclic collector while it runs and restores it as
it found it. Run inside a step, the collector would promote the
activation checkpoints' per-saved-tensor objects (alive from a layer's
forward to its backward) to the old generation, whose full passes then scan
the job's whole heap inside a step (~0.2 s a pass on an H100's host, one
step in ~15 of Granite-4.0-H's, which saves ~9x LLaVA-NeXT's tensors a
step). Paused, those objects die by reference count before any pass. The
cycles a forward pass made are collected before its backward pass by a young
pass (``gc.collect(0)``), which scans only the objects made since the last
pass: on a job's first step the first checkpoint's lazy import of
``torch._dynamo`` leaves such cycles, holding the frames of ``loss_fn`` and
``decoder_hidden`` and so their activations (the logits among them).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import torch

from repro_torch.models.convert import train_state_to_tree
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    accum: int = 1
    log_every: int = 10
    checkpoint_every: int = 0      # 0 = never
    opt: AdamWConfig = AdamWConfig()


def _trainable(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_train_state(model, generator: "torch.Generator | int", opt_cfg: AdamWConfig) -> dict:
    params = model.init(generator)
    return {"params": params, "opt": adamw_init(_trainable(params), opt_cfg)}


def build_train_step(model, opt_cfg: AdamWConfig, accum: int = 1) -> Callable:
    def value_and_grad(params, named, batch):
        total, metrics = model.loss_fn(params, batch)
        gc.collect(0)
        return total.detach(), metrics, torch.autograd.grad(total, list(named.values()))

    def train_step(state, batch):
        running = gc.isenabled()
        gc.disable()
        try:
            return step(state, batch)
        finally:
            if running:
                gc.enable()

    def step(state, batch):
        params = state["params"]
        named = _trainable(params)
        if accum == 1:
            loss, metrics, g = value_and_grad(params, named, batch)
            grads = dict(zip(named, g))
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
                l, _, g = value_and_grad(params, named, mb)
                for acc, gi in zip(grads.values(), g):
                    acc.add_(gi)
                lsum = lsum + l
                del g
            for acc in grads.values():
                acc.div_(accum)
            loss = lsum / accum
            zero = torch.zeros((), dtype=torch.float32, device=model.device)
            metrics = {"loss": loss, "aux_loss": zero, "tokens": zero}
        _, opt, opt_metrics = adamw_update(named, grads, state["opt"], opt_cfg)
        metrics = {**metrics, **opt_metrics, "total_loss": loss}
        return {"params": params, "opt": opt}, metrics

    return train_step


def train_loop(
    model,
    data,
    cfg: TrainConfig,
    generator: "torch.Generator | int | None" = None,
    checkpointer=None,
    state=None,
    start_step: int = 0,
) -> tuple[Any, list[dict]]:
    """Single-host driver used by the launcher and the tests.
    `checkpointer` is a repro_torch.checkpoint.DedupCheckpointer (optional);
    every `checkpoint_every` steps it saves the state as the JAX package's
    train-state tree (``train_state_to_tree``)."""
    if state is None:
        state = init_train_state(model, generator if generator is not None else 0, cfg.opt)
    step_fn = build_train_step(model, cfg.opt, cfg.accum)
    history = []
    for step in range(start_step, cfg.steps):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in data.batch(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["total_loss"])
        dt = time.perf_counter() - t0
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            history.append({"step": step, "loss": loss, "sec": dt})
        if checkpointer is not None and cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
            checkpointer.save(f"step-{step + 1}", train_state_to_tree(state, model.cfg))
    return state, history
