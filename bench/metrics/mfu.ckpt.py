"""``mfu.train`` over a checkpointing job's untraced steps."""

from bench.run import reader

read = reader("mfu.train")
