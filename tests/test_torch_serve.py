"""The port's serving slice against the reference on the CPU: data and
request streams bit-identical to the reference's, the same served
(id, label, prediction) sequence from ``api.serve`` on the same
parameters, traffic and seed, and the serving machinery's own
contracts (bus consistency, version-vector audit, admission, batching,
facade validation)."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro.core import ff_mlp as jmlp
from repro.serve import RequestStream as JStream
from repro.serve.traffic import traffic as jtraffic
from repro_torch import api as tapi, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.convert import params_from_numpy
from repro_torch.serve import (
    AdmissionQueue, Batcher, Replica, Request, RequestStream, ServeConfig,
    WeightBus,
)
from repro_torch.serve.traffic import traffic as ttraffic

SIZES = (784, 64, 32)


# ---------------------------------------------------------------------------
# Data and traffic: bit-identical to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,seed", [("mnist_like", 0), ("mnist_like", 3),
                                       ("cifar_like", 1)])
def test_image_tasks_are_bit_identical(name, seed):
    t = getattr(tdata, name)(seed=seed, n_train=40, n_test=24)
    j = getattr(jdata, name)(seed=seed, n_train=40, n_test=24)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (t.num_classes, t.dim) == (j.num_classes, j.dim)


def test_source_samples_are_bit_identical():
    pairs = [(tdata.mnist_source(2), jdata.mnist_source(2)),
             (tdata.source_of(tdata.mnist_like(n_train=16, n_test=32)),
              jdata.source_of(jdata.mnist_like(n_train=16, n_test=32)))]
    for t, j in pairs:
        assert isinstance(t, tdata.Source)
        for split, seed in (("serve", 5), ("other", 5), ("serve", 6)):
            (tx, ty), (jx, jy) = t.sample(split, 20, seed), \
                j.sample(split, 20, seed)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


@pytest.fixture(scope="module")
def sources():
    return (tdata.source_of(tdata.mnist_like(n_train=16, n_test=256)),
            jdata.source_of(jdata.mnist_like(n_train=16, n_test=256)))


@pytest.mark.parametrize("name", ["uniform", "zipf", "bursty"])
def test_request_streams_are_identical(sources, name):
    t = RequestStream(sources[0], ttraffic.get(name), rate=100.0, seed=7)
    j = JStream(sources[1], jtraffic.get(name), rate=100.0, seed=7)
    a, b = t.take(150) + t.take(150), j.take(300)   # across chunk refills
    assert [ta for ta, _ in a] == [tb for tb, _ in b]
    for (_, ra), (_, rb) in zip(a, b):
        assert (ra.id, ra.label, ra.t_arrival) == (rb.id, rb.label,
                                                   rb.t_arrival)
        assert np.array_equal(ra.x, rb.x)
    assert ttraffic.names() == jtraffic.names()


# ---------------------------------------------------------------------------
# api.serve: the same served sequence as the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    init = jax.jit(jmlp.init, static_argnums=1)
    return jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(0), JConfig(layer_sizes=SIZES)))


@pytest.mark.parametrize("traffic", ["bursty", "zipf"])
def test_serve_static_matches_reference(ref_params, traffic):
    """Same params, traffic and seed: the port's ``api.serve`` on the
    CPU and the reference's ``api.serve`` score the same requests and
    predict the same labels (as in tests/test_serve.py's replay)."""
    knobs = dict(traffic=traffic, n_requests=192, seed=5, rate=2000.0)
    jtask = jdata.mnist_like(n_train=16, n_test=256)
    ttask = tdata.mnist_like(n_train=16, n_test=256)
    want = japi.serve(JConfig(layer_sizes=SIZES), jtask,
                      params=jax.tree_util.tree_map(jnp.asarray, ref_params),
                      **knobs)
    got = tapi.serve(TConfig(layer_sizes=SIZES), ttask,
                     params=params_from_numpy(ref_params, "cpu"),
                     device="cpu", **knobs)
    key = lambda r: (r["id"], r["label"], r["pred"])      # noqa: E731
    assert list(map(key, got.records)) == list(map(key, want.records))
    assert len(got.records) == 192 and got.device == "cpu"
    assert got.slo["consistency_violations"] == 0
    assert got.slo["accuracy"] == pytest.approx(want.slo["accuracy"])
    # every request was scored in a padded max_batch batch, 2 layers each
    assert got.raw.batches_scored >= 192 // 64


def test_serve_sheds_when_the_queue_overflows(ref_params):
    """A rate far above what one tick admits must shed, and the SLO block
    must account for it (the reference's shed-accounting test)."""
    res = tapi.serve(TConfig(layer_sizes=SIZES),
                     tdata.mnist_like(n_train=16, n_test=128),
                     params=params_from_numpy(ref_params, "cpu"),
                     device="cpu", traffic="uniform", n_requests=256,
                     rate=1e6, max_batch=16, queue_cap=32, seed=0)
    slo = res.slo
    assert slo["requests"] == slo["accepted"]
    assert slo["accepted"] + slo["rejected"] == 256
    assert slo["rejected"] > 0 and slo["shed_rate"] > 0.0
    assert slo["queue_depth_peak"] <= 32
    assert slo["latency_p99_ms"] >= slo["latency_p50_ms"]


def test_serve_facade_validation(ref_params):
    cfg = TConfig(layer_sizes=SIZES)
    task = tdata.mnist_like(n_train=16, n_test=32)
    params = params_from_numpy(ref_params, "cpu")
    with pytest.raises(NotImplementedError, match="executor"):
        tapi.serve(cfg, task, device="cpu")
    with pytest.raises(TypeError, match="knob"):
        tapi.serve(cfg, task, params=params, device="cpu", bogus_knob=3)
    with pytest.raises(ValueError, match="unknown traffic"):
        tapi.serve(cfg, task, params=params, device="cpu", traffic="nope")
    with pytest.raises(ValueError, match="task or"):
        tapi.serve(cfg, params=params, device="cpu")
    with pytest.raises(ValueError, match="unknown ff_dense impl"):
        tapi.serve(TConfig(layer_sizes=SIZES, kernel_impl="pallas"), task,
                   params=params, device="cpu")
    with pytest.raises(ValueError, match="goodness_fn='perf_opt'"):
        tapi.serve(TConfig(layer_sizes=SIZES, classifier="perf_opt_all"),
                   task, params=params, device="cpu")


# ---------------------------------------------------------------------------
# WeightBus + Replica: the consistency contract
# ---------------------------------------------------------------------------

def _layer_piece(k, version, dim=4):
    """A per-layer piece whose bits encode (layer, version), so a torn
    snapshot shows in the content, not only in the version tag."""
    return {"layers": [{"w": torch.full((dim, dim), float(version * 100 + k)),
                        "b": torch.zeros(dim)}]}


def test_bus_exposes_only_fully_published_versions():
    bus = WeightBus(3, has_head=True)
    bus.publish_layer(0, 0, _layer_piece(0, 0))
    bus.publish_layer(1, 0, _layer_piece(1, 0))
    assert bus.next_snapshot(-10) is None          # layer 2 + head missing
    bus.publish_layer(2, 0, _layer_piece(2, 0))
    assert bus.next_snapshot(-10) is None          # head still missing
    bus.publish_head(0, {"w": torch.ones(3, 2)})
    ver, params, vec, _ = bus.next_snapshot(-10)
    assert ver == 0 and vec == [0, 0, 0, 0]
    assert len(params["layers"]) == 3 and "head" in params
    for k, lp in enumerate(params["layers"]):
        assert float(lp["w"][0, 0]) == k


def test_bus_snapshots_step_in_version_order():
    bus = WeightBus(1)
    for v in (2, 0, 1):                            # out-of-order assembly
        bus.publish_layer(0, v, _layer_piece(0, v))
    seen, after = [], -10
    while (rec := bus.next_snapshot(after)) is not None:
        seen.append(rec[0])
        after = rec[0]
    assert seen == [0, 1, 2] and bus.latest_version() == 2


def test_bus_clones_published_tensors():
    """Copy on publish: an in-place update of the producer's tensor after
    publication must not reach the parked snapshot."""
    bus = WeightBus(1)
    piece = _layer_piece(0, 0)
    bus.publish_layer(0, 0, piece)
    piece["layers"][0]["w"].fill_(-1.0)
    _, params, _, _ = bus.next_snapshot(-10)
    assert float(params["layers"][0]["w"][0, 0]) == 0.0


def test_concurrent_publish_never_yields_torn_snapshot():
    """A consumer hammering the bus while a producer publishes layer by
    layer never sees a half-published layer set."""
    n_layers, n_versions = 3, 12
    bus = WeightBus(n_layers)
    stop = threading.Event()

    def producer():
        for v in range(n_versions):
            for k in range(n_layers):
                bus.publish_layer(k, v, _layer_piece(k, v))
                time.sleep(0.0003)                 # widen the torn window
        stop.set()

    th = threading.Thread(target=producer)
    th.start()
    installed, after = [], -10
    deadline = time.monotonic() + 30.0
    while not (stop.is_set() and bus.next_snapshot(after) is None):
        assert time.monotonic() < deadline, "producer never finished"
        rec = bus.next_snapshot(after)
        if rec is None:
            continue
        ver, params, vec, _ = rec
        assert vec == [ver] * n_layers
        for k, lp in enumerate(params["layers"]):
            assert float(lp["w"][0, 0]) == ver * 100 + k, "torn snapshot"
        installed.append(ver)
        after = ver
    th.join(timeout=30.0)
    assert not th.is_alive()
    assert installed == list(range(n_versions))    # monotone, none skipped


def test_replica_counts_version_vector_violations():
    r = Replica(10, max_batch=8)
    params = {"layers": [_layer_piece(0, 0)["layers"][0]]}
    assert r.install(0, params, [0], time.perf_counter())
    assert not r.install(1, params, [1, 0], time.perf_counter())  # torn
    assert not r.install(0, params, [0], time.perf_counter())     # backward
    assert r.consistency_violations == 2
    assert r.version == 0 and len(r.swaps) == 1


def test_replica_pads_to_max_batch_and_refuses_oversize(ref_params):
    params = params_from_numpy(ref_params, "cpu")
    r = Replica(10, max_batch=8)
    with pytest.raises(RuntimeError, match="no installed snapshot"):
        r.score(np.zeros((2, 784), np.float32))
    r.install(0, params, [0, 0], time.perf_counter())
    x = tdata.mnist_like(n_train=16, n_test=8).x_test
    full = r.score(x)
    part = r.score(x[:3])                          # padded with zero rows
    assert part.shape == (3, 10) and r.batches_scored == 2
    np.testing.assert_allclose(part, full[:3], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        r.score(np.zeros((9, 784), np.float32))


# ---------------------------------------------------------------------------
# Queue + batcher
# ---------------------------------------------------------------------------

def _req(i, t=0.0):
    return Request(id=i, x=np.zeros(4, np.float32), label=0, t_arrival=t)


def test_queue_sheds_on_full_and_keeps_fifo_order():
    q = AdmissionQueue(4)
    assert [q.offer(_req(i)) for i in range(6)] == [True] * 4 + [False] * 2
    assert q.stats == {"accepted": 4, "rejected": 2, "depth_peak": 4}
    assert [r.id for r in q.take(10)] == [0, 1, 2, 3]
    assert len(q) == 0 and q.offer(_req(9))


def test_batcher_max_batch_and_max_wait():
    q = AdmissionQueue(64)
    b = Batcher(max_batch=4, max_wait_s=0.5)
    for i in range(3):
        q.offer(_req(i, t=0.0))
    assert b.form(q, now=0.1) == []                # 3 < 4 and young
    assert [r.id for r in b.form(q, now=0.6)] == [0, 1, 2]   # head waited
    for i in range(5):
        q.offer(_req(10 + i, t=1.0))
    assert [r.id for r in b.form(q, now=1.0)] == [10, 11, 12, 13]  # full
    assert b.form(q, now=1.0) == []
    assert [r.id for r in b.form(q, now=1.0, flush=True)] == [14]


def test_serve_config_rejects_unknown_traffic():
    with pytest.raises(ValueError, match="unknown traffic"):
        ServeConfig(traffic="no_such_traffic")
