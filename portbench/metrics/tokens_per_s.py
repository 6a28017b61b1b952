"""Tokens (batch x seq, corruptions not counted) that completed a
block's grad step, summed over the blocks over their number, per second
of the window."""


def read(run):
    if run.unit != "tokens":
        return None
    return run.work / run.window_s
