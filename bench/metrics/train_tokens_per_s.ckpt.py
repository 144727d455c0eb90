"""A checkpointing job's goodput, read as ``train_tokens_per_s`` reads it: the
tokens of every step in the window over the window's seconds, with the
saves, deletions, crashes and restores in it. Its own name, since the host
paces these cells and their runs spread far more than a job's steps alone."""

from bench.run import reader

read = reader("train_tokens_per_s")
