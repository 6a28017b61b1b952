"""Share of the window in the chapter schedule's head tasks, host time
around work that ends in a synchronize."""


def read(run):
    spent = sum(b - a for name, a, b in run.spans if name == "head")
    if run.unit != "tokens" or not spent:
        return None
    return 100.0 * spent / run.window_s
