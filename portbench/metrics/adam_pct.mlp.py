"""Share of the window in Adam's updates of the MLP's layer tasks
(``ff_mlp.train_layer_chapter``): the summed CUDA-event time of its
``mlp.adam`` spans."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("mlp.adam",))
