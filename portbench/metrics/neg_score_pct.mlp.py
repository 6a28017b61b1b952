"""Share of the window in AdaptiveNEG's scoring of the train set
(``pff._class_scores_chunked``): the summed CUDA-event time of its
``mlp.neg.score`` spans."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("mlp.neg.score",))
