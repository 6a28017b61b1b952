"""``repro_torch.api.fit`` against the reference's ``repro.api.fit`` on
the CPU, fed the reference's own random draws (``JaxKey``): the
sequential backend under every negatives / goodness / classifier
strategy, the federated backend, the shard split, and the schedule
simulator replaying the reference's own task records."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro.core import ff_mlp as jmlp, pff as jpff
from repro_torch import api as tapi, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.convert import params_to_numpy
from repro_torch.core import ff_mlp as tmlp, pff as tpff

from test_torch_train import JaxKey

# Final params: the reference's ref-vs-fused weight gate (1e-4 max-abs),
# held by all but at most 1 in 10^4 elements of each leaf, and 1e-3 by
# every element. Where two f32 summation orders disagree on the side of
# a knife-edge (a gradient that cancels to within rounding, a
# pre-activation within rounding of the relu boundary), Adam's
# normalized step moves the weights involved by ~1e-4: on this config
# the port against itself, with 1 BLAS thread instead of 8, already
# differs by 9e-5 in one element of layer 0's 50176.
WEIGHT_TOL, OUTLIER_SHARE, OUTLIER_TOL = 1e-4, 1e-4, 1e-3
MARGIN = 1e-4              # predictions compared where top-2 margin > this
BASE = dict(layer_sizes=(784, 64, 48), epochs=4, splits=2, batch_size=32,
            seed=0)
STRATEGIES = {
    "random": dict(neg_mode="random"),
    "fixed": dict(neg_mode="fixed"),
    "adaptive": dict(neg_mode="adaptive"),
    "softmax": dict(neg_mode="random", classifier="softmax"),
    "perf_opt": dict(goodness_fn="perf_opt"),
}
CASES = [(name, "sequential") for name in STRATEGIES] + [
    ("random", "federated")]


@pytest.fixture(scope="module")
def task():
    return tdata.mnist_like(seed=0, n_train=256, n_test=200)


@pytest.fixture(scope="module")
def reference_fits():
    """One reference fit per case, shared by the tests below."""
    jtask = jdata.mnist_like(seed=0, n_train=256, n_test=200)
    return {(name, backend): japi.fit(
        JConfig(**BASE, **STRATEGIES[name]), jtask, backend=backend,
        num_nodes=2) for name, backend in CASES}


@pytest.mark.parametrize("name,backend", CASES)
def test_fit_matches_reference(name, backend, task, reference_fits):
    want = reference_fits[(name, backend)]
    tcfg = TConfig(**BASE, **STRATEGIES[name])
    got = tapi.fit(tcfg, task, backend=backend, num_nodes=2, device="cpu",
                   key=JaxKey(tcfg.seed))
    assert got.device == "cpu" and got.schedule == want.schedule
    gp = params_to_numpy(got.params)
    wp = jax.tree_util.tree_map(np.asarray, want.params)
    assert jax.tree_util.tree_structure(gp) == \
        jax.tree_util.tree_structure(wp)
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(wp)):
        d = np.abs(a - b)
        assert float(d.max()) <= OUTLIER_TOL, float(d.max())
        assert (d > WEIGHT_TOL).sum() <= OUTLIER_SHARE * d.size, \
            np.sort(d.ravel())[-5:]
    assert [(r.kind, r.layer, r.chapter) for r in got.records] == \
        [(r.kind, r.layer, r.chapter) for r in want.records]
    # predictions (each package's own scorer) agree wherever the
    # reference's top-2 margin decides them
    mode = {"perf_opt": "perf_opt_all", "softmax": "softmax"}.get(
        name, "goodness")
    ws = np.asarray(jmlp.class_scores(
        jax.tree_util.tree_map(jnp.asarray, wp), jnp.asarray(task.x_test),
        tcfg.num_classes, mode, impl="ref"))
    gs = tmlp.class_scores(got.params, torch.as_tensor(task.x_test),
                           tcfg.num_classes, mode).numpy()
    top2 = np.sort(ws, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN * np.abs(ws).max()
    np.testing.assert_array_equal(gs.argmax(1)[decided],
                                  ws.argmax(1)[decided])
    assert abs(got.test_acc - want.test_acc) <= 1e-6 + 1 - decided.mean()


def test_federated_shards_are_the_references():
    for n_train, nodes in ((256, 2), (1000, 3), (15000, 4)):
        t = tdata.mnist_like(seed=0, n_train=n_train, n_test=8)
        j = jdata.mnist_like(seed=0, n_train=n_train, n_test=8)
        for seed in (0, 5):
            got = tpff.federated_shards(TConfig(seed=seed), t, nodes)
            want = jpff.federated_shards(JConfig(seed=seed), j, nodes)
            assert len(got) == len(want) == nodes
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("schedule", ["sequential", "single_layer",
                                      "all_layers", "federated"])
def test_simulate_replays_reference_records_identically(schedule,
                                                        reference_fits):
    for key in (("adaptive", "sequential"), ("softmax", "sequential"),
                ("perf_opt", "sequential")):
        jrecs = reference_fits[key].records
        trecs = [tpff.TaskRecord(**dataclasses.asdict(r)) for r in jrecs]
        for nodes in (1, 2, 4):
            for comm in (0.0, 0.003):
                want = jpff.simulate_schedule(jrecs, schedule, nodes,
                                              comm_time=comm)
                got = tapi.simulate(trecs, schedule, nodes, comm_time=comm)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_simulate_backend_and_facade(task):
    cfg = TConfig(**dict(BASE, epochs=2), neg_mode="random")
    res = tapi.fit(cfg, task, backend="simulate", num_nodes=4,
                   schedule="single_layer", device="cpu")
    assert res.schedule == "single_layer" and res.sim.num_nodes == 4
    assert res.makespan == res.sim.makespan and res.speedup > 0
    again = tapi.simulate(res, "single_layer", 4)
    assert dataclasses.asdict(again) == dataclasses.asdict(res.sim)
    assert tapi.fit(cfg, task, backend="simulate", device="cpu").schedule \
        == "sequential"
    with pytest.raises(ValueError, match="no task records"):
        tapi.simulate(dataclasses.replace(res, records=None), "all_layers",
                      2)


# The executor backend and train-while-serve (fit(serve=...)) are
# ported, and so are LM configs with MoE blocks and the pod backend,
# which refuses an MLP config as the reference's does; the LM backends
# (the chapter schedule) refuse a config that reads stub frontend
# embeddings, as the reference's schedule takes none, naming the joint
# step that trains it.
_NO_AUX = "takes no stub frontend embeddings"


@pytest.mark.parametrize("backend,kw,slice_name", [
    ("executor", {"enc_dec": True}, _NO_AUX),
    ("pod", {}, "pod"),
    ("executor", {"config": "llama-3.2-vision-90b"}, _NO_AUX),
    ("sequential", {"config": "seamless-m4t-large-v2"}, _NO_AUX)],
    ids=["executor-executor", "pod-pod", "executor-llama-vision",
         "sequential-seamless"])
def test_unported_backends_name_their_slice(backend, kw, slice_name, task):
    from repro_torch.configs import get_config
    cfg = TConfig(**BASE)
    if kw.get("enc_dec"):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                  enc_dec=True)
        task = None
    if kw.get("config"):
        cfg, task = get_config(kw["config"]).reduced(), None
    with pytest.raises(ValueError, match=slice_name):
        tapi.fit(cfg, task, backend=backend, device="cpu")


def test_fit_validates_its_config(task):
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.fit(TConfig(**BASE), task, backend="nope", device="cpu")
    with pytest.raises(KeyError, match="unknown negatives strategy"):
        tapi.fit(TConfig(**BASE, neg_mode="nope"), task, device="cpu")
    with pytest.raises(ValueError, match="reads parameters trained by"):
        tapi.fit(TConfig(**BASE, classifier="perf_opt_all"), task,
                 device="cpu")
