from repro_torch.data.pipeline import (
    DedupWorkload,
    SyntheticLMData,
    make_dedup_objects,
)

__all__ = ["DedupWorkload", "SyntheticLMData", "make_dedup_objects"]
