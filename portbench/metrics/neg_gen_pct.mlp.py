"""Share of the window in the chapter schedule's ``neg_gen`` tasks
(AdaptiveNEG's scoring and draw), host time around work that ends in a
synchronize."""


def read(run):
    spent = sum(b - a for name, a, b in run.spans if name == "neg_gen")
    if run.unit != "samples" or not spent:
        return None
    return 100.0 * spent / run.window_s
