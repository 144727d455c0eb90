"""``optimizer_ms.train`` over a checkpointing job's traced steps."""

from bench.run import reader

read = reader("optimizer_ms.train")
