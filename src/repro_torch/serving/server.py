"""Batched server with cluster-wide KV prefix-cache dedup.

A port of the JAX package's ``serving/server.py``. It exercises the real
logic end to end: chain-fingerprint prefix matching against the
shared-nothing block store, KV reconstruction from stored block payloads,
decode of the uncached suffix, greedy generation, block publication, and the
pin/evict lifecycle. Decode runs eagerly, one token per ``decode_step``.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.core import DedupCluster, Fingerprint, ReadError
from repro_torch.models.transformer import zeros_from_specs
from repro_torch.serving.kv_dedup import KVBlockCache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 256
    block_tokens: int = 16
    max_cached_blocks: int = 4096


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """A host copy of ``t``; bfloat16 comes back as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _kv_to_bytes(k: torch.Tensor, v: torch.Tensor) -> bytes:
    """The JAX package's payload format: an npz of k and v, bfloat16 as
    uint16 bits, with a ``bf16`` flag."""
    kn, bf16 = _to_numpy(k)
    vn, _ = _to_numpy(v)
    buf = io.BytesIO()
    np.savez(buf, k=kn, v=vn, bf16=np.asarray(bf16))
    return buf.getvalue()


def _kv_from_bytes(data: bytes) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v) as CPU tensors, bfloat16 where the payload's flag says so."""
    z = np.load(io.BytesIO(data))
    k, v = torch.from_numpy(np.array(z["k"])), torch.from_numpy(np.array(z["v"]))
    if bool(z["bf16"]):
        k, v = k.view(torch.bfloat16), v.view(torch.bfloat16)
    return k, v


class BatchedServer:
    """Serves a decoder LM whose every block is plain {k, v} attention."""

    def __init__(self, model, params, cluster: DedupCluster, cfg: ServeConfig | None = None):
        if model.cfg.enc_dec or set(model.cfg.block_pattern) != {"attn_global"}:
            raise ValueError("the server supports plain global-attention decoders")
        self.model = model
        self.params = params
        self.cfg = cfg or ServeConfig()
        self.kv = KVBlockCache(cluster, self.cfg.block_tokens)
        self.device = model.device

    # ------------------------------------------------------------ internals
    def _empty_caches(self):
        spec = ShapeSpec("serve", self.cfg.max_len, 1, "decode")
        return zeros_from_specs(self.model.cache_specs(spec), self.device)

    def _load_prefix(self, caches, fps: list[Fingerprint]):
        """Install stored KV block payloads into the cache tensors.

        The JAX version copies the caches to host, fills them and copies
        them back; here each block goes straight into its slots of the
        device tensors, in place."""
        scanned, _ = caches
        k, v = scanned[0]["k"], scanned[0]["v"]
        bt = self.cfg.block_tokens
        for i, fp in enumerate(fps):
            bk, bv = _kv_from_bytes(self.kv.get_block(fp))
            k[:, :, i * bt : (i + 1) * bt] = bk.to(self.device)
            v[:, :, i * bt : (i + 1) * bt] = bv.to(self.device)
        return caches

    def _publish_blocks(self, caches, tokens: list[int], start_block: int):
        """Serialize newly computed KV blocks and publish to the cluster."""
        scanned, _ = caches
        k, v = scanned[0]["k"], scanned[0]["v"]
        bt = self.cfg.block_tokens
        fps = self.kv.block_fps(tokens)
        new_fps, payloads = [], []
        for i in range(start_block, len(fps)):
            new_fps.append(fps[i])
            payloads.append(_kv_to_bytes(k[:, :, i * bt : (i + 1) * bt], v[:, :, i * bt : (i + 1) * bt]))
        self.kv.put_blocks(new_fps, payloads)
        return fps[:start_block] + new_fps

    def _step(self, caches, token: int, pos: int):
        tok = torch.tensor([[token]], dtype=torch.int32, device=self.device)
        return self.model.decode_step(self.params, caches, tok, pos)

    # --------------------------------------------------------------- public
    def handle(self, prompt: list[int], gen_tokens: int = 8) -> dict:
        """Process one request. Returns {tokens, reused_tokens, computed_tokens}."""
        if len(prompt) + gen_tokens > self.cfg.max_len:
            raise ValueError(f"{len(prompt)} prompt + {gen_tokens} generated tokens exceed max_len {self.cfg.max_len}")
        n_cached, matched = self.kv.match_prefix(prompt)
        if n_cached >= len(prompt):
            # Always recompute at least the final prompt token: its logits
            # are needed to start generation (cache stores KV, not logits).
            self.kv.release_blocks(matched[-1:])
            matched = matched[:-1]
            n_cached -= self.kv.block_tokens
        caches = self._empty_caches()
        if matched:
            try:
                caches = self._load_prefix(caches, matched)
            except ReadError:
                # best-effort cache: block bytes lost (e.g. node death with
                # replicas=1) -> treat as a miss and recompute everything
                self.kv.release_blocks(matched)
                matched, n_cached = [], 0
                caches = self._empty_caches()

        # the uncached suffix goes through the decode step one token at a
        # time, so one step function serves both phases
        logits = None
        for t in range(n_cached, len(prompt)):
            logits, caches = self._step(caches, prompt[t], t)

        all_fps = self._publish_blocks(caches, prompt, len(matched))

        out: list[int] = []
        pos = len(prompt)
        tok_next = int(torch.argmax(logits[0, -1])) if logits is not None else prompt[-1]
        for _ in range(gen_tokens):
            out.append(tok_next)
            logits, caches = self._step(caches, tok_next, pos)
            tok_next = int(torch.argmax(logits[0, -1]))
            pos += 1

        self.kv.release_blocks(all_fps)
        self.kv.evict(self.cfg.max_cached_blocks)
        return {
            "tokens": out,
            "reused_tokens": n_cached,
            "computed_tokens": len(prompt) - n_cached + gen_tokens,
        }
