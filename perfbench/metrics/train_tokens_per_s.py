"""Tokens trained a second: the tokens of every step completed in the window over
the window's seconds (host clock, from before the window's first step to the
synchronising ``float(loss)`` of its last)."""


def read(run):
    return len(run.step_s) * run.tokens_per_step / run.window_s
