"""``mfu.train`` over the Granite cell's untraced steps: its family file's
model FLOPs (the routed experts at the share of a token's choices that land
on the experts held here) over the steps' wall seconds and the bf16 peak."""

from bench.run import reader

read = reader("mfu.train")
