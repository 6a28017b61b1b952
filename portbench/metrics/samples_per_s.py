"""Positive training samples that completed a layer's grad step, summed
over the layers over their number, per second of the window."""


def read(run):
    if run.unit != "samples":
        return None
    return run.work / run.window_s
