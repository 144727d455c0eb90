"""``device_idle.train`` over the Granite cell's traced steps."""

from bench.run import reader

read = reader("device_idle.train")
