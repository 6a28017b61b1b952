"""The port's PFF executor against the reference's, on the CPU: both fed
the same random draws (the port through ``JaxKey``, the reference's own
``jax.random``), All-Layers on 4 nodes and Single-Layer on 2 nodes, with
AdaptiveNEG negatives and the softmax head, so the published negatives,
the head hand-off and the Single-Layer forward recompute all cross
nodes. The reference runs in-process with one device standing for its
N nodes, as ``tests/test_pff_faults.py`` runs it.

Tolerance: ``tests/test_torch_fit.py``'s, for the same reason (two f32
summation orders meeting knife-edges move a few weights by ~lr): at
least 99.99% of each leaf within 1e-4, every element within 1e-3; and
test accuracy within 0.02 (4 of the 200 test rows, where such a weight
tips a prediction)."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi, data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro_torch import api as tapi, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.convert import params_to_numpy

from test_torch_fit import OUTLIER_SHARE, OUTLIER_TOL, WEIGHT_TOL
from test_torch_train import JaxKey

BASE = dict(layer_sizes=(784, 128, 128), epochs=6, splits=3,
            neg_mode="adaptive", classifier="softmax", batch_size=64,
            seed=0)


@pytest.mark.parametrize("schedule,nodes", [("all_layers", 4),
                                            ("single_layer", 2)])
def test_executor_matches_the_reference_executor(schedule, nodes):
    jtask = jdata.mnist_like(n_train=520, n_test=200)
    d0 = jax.devices()[0]
    want = japi.fit(JConfig(**BASE), jtask, backend="executor",
                    schedule=schedule, num_nodes=nodes, devices=[d0] * nodes)
    cfg = TConfig(**BASE)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = tapi.fit(cfg, tdata.mnist_like(n_train=520, n_test=200),
                       backend="executor", schedule=schedule,
                       num_nodes=nodes, device="cpu", key=JaxKey(cfg.seed))
    finally:
        torch.use_deterministic_algorithms(prev)
    gp = params_to_numpy({"layers": got.params["layers"],
                          "head": got.params["head"]})
    wp = jax.tree_util.tree_map(np.asarray, {"layers": want.params["layers"],
                                             "head": want.params["head"]})
    assert jax.tree_util.tree_structure(gp) == \
        jax.tree_util.tree_structure(wp)
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(wp)):
        d = np.abs(a - b)
        assert float(d.max()) <= OUTLIER_TOL, float(d.max())
        assert (d > WEIGHT_TOL).sum() <= OUTLIER_SHARE * d.size, \
            np.sort(d.ravel())[-5:]
    # the same hand-off pattern: the same transfers parked and hit (the
    # reference counts its same-device pulls local, the port counts a
    # pull from another node cross)
    for k in ("prefetch_issued", "prefetch_hits"):
        assert got.raw.handoff[k] == want.raw.handoff[k], k
    assert abs(got.test_acc - want.test_acc) <= 0.02
