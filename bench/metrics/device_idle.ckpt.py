"""``device_idle.train`` over a checkpointing job's steps."""

from bench.run import reader

read = reader("device_idle.train")
