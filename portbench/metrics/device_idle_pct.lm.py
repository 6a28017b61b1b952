"""Share of the traced window in which the card ran no kernel, copy or
set (the union over its streams)."""


def read(run):
    if run.trace is None or run.unit != "tokens":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
