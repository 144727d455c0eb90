from repro_torch.checkpoint.dedup_ckpt import CheckpointConfig, DedupCheckpointer

__all__ = ["CheckpointConfig", "DedupCheckpointer"]
