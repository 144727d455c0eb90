"""Goodput: the tokens of every train step completed in the window over the
window's seconds (host clock). Saves, deletions, crashes and restores in
the window count against it."""


def read(run):
    steps = run.ops("step")
    if not steps:
        return None
    return sum(r.info["tokens"] for r in steps) / run.window_s
