#!/usr/bin/env python3
"""One reduced train step of Qwen1.5-MoE-A2.7B and of Mamba2-1.3B on the
card, profiled by operation as ``chip_smoke.py``'s train phases do
(``profile_step_by_op`` with ``step_categories``): the quick check that
every category a step has on the card takes its operations, the
embedding's gather and backward included.

    python3 tools/step_categories_quick.py

Prints each arch's device ms and launches by category; exits 1 when the
embedding's category takes no device time. Under a minute on an H100
(at reduced size only the inherited categories, the optimizer and the
embedding, are meaningful: the shape categories expect train_4k).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_categories_quick: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import build_train_step, init_train_state

    ok = True
    for arch in ("qwen2-moe-a2.7b", "mamba2-1.3b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=torch.bfloat16, attn_impl="dense",
                                  remat="full")
        model, opt = build_model(cfg), AdamWConfig()
        state = init_train_state(model, 0, opt)
        step = build_train_step(model, opt, 2)
        tokens = torch.randint(0, cfg.vocab, (2, 129), device="cuda")
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        step(state, batch)  # warm-up
        prof = C.profile_step_by_op(lambda: float(step(state, batch)[1]["total_loss"]), C.step_categories(cfg))
        print(arch, json.dumps(prof["device_ms_by_op"]), flush=True)
        ok &= prof["device_ms_by_op"]["embedding (gather, its backward)"][0] > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
