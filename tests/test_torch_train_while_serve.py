"""Train-while-serve on the CPU: the executor trains the FF MLP on a
``pff-train`` thread and hot-publishes every freshly trained layer into
the bus the serving loop scores from.

- The reference's ``test_train_while_serve_e2e_smoke``
  (``tests/test_serve.py``), held within the port at half its width: one
  hot-swap per chapter, 0 consistency violations, the final-version
  window beats the untrained one, and publication leaves the weight
  stream bit-exact.
- Against the reference at a small config, both fed the reference's
  draws (``JaxKey``): the same swap versions, and final params at the
  executor parity rule of ``tests/test_torch_exec_parity.py``.
- ``fit(serve=...)``, the facade's argument errors, a training
  exception re-raised, the kernel counters exact across threads, and
  ``launch.serve --mode ff`` on the CPU."""
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro import api as japi, data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro_torch import api as tapi, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.convert import params_to_numpy
from repro_torch.core import pff_exec
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.serve import engine

from test_torch_fit import OUTLIER_SHARE, OUTLIER_TOL, WEIGHT_TOL
from test_torch_train import JaxKey

SMALL = dict(layer_sizes=(784, 64, 64), epochs=8, splits=4,
             neg_mode="random", classifier="goodness", batch_size=64,
             seed=0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the trainer and the serving loop each run many
    small ops, which more threads only slow down under the test
    workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_train_while_serve_e2e_smoke():
    """The reference's acceptance invariants on the CPU: at least one
    completed hot-swap per chapter, zero consistency violations, request
    accuracy improves across the swap timeline, and live publication
    leaves the training weight stream bit-exact. The reference's config
    at half its width (128 for 256): the same 8000 grad steps at a
    quarter of the products, which still clear its gates (final window
    ~0.7, test accuracy 0.62)."""
    task = tdata.mnist_like(n_train=2560, n_test=400)
    cfg = TConfig(layer_sizes=(784, 128, 128), epochs=100, splits=4,
                  neg_mode="random", classifier="goodness", batch_size=64,
                  seed=0)
    res = tapi.serve(cfg, task, traffic="zipf", schedule="sequential",
                     num_nodes=1, rate=300.0, max_batch=64, seed=1,
                     device="cpu")

    assert res.slo["consistency_violations"] == 0
    # init snapshot (-1) + one per completed chapter
    assert [s["version"] for s in res.swaps] == [-1] + list(
        range(cfg.splits))
    assert res.slo["requests"] > 0
    assert all(s["staleness_s"] >= 0 for s in res.swaps)

    # accuracy-vs-time: the last-version window must beat the untrained
    # (-1) window decisively (chance is 0.1)
    curve = res.accuracy_by_version
    first, last = min(curve), max(curve)
    assert last == cfg.splits - 1
    assert curve[last]["n"] >= 64                  # final_probe window
    assert curve[last]["accuracy"] > curve[first]["accuracy"] + 0.2
    assert curve[last]["accuracy"] > 0.4

    r0 = res.records[0]
    assert {"id", "t_arrival", "t_done", "latency", "version", "pred",
            "label", "correct"} <= set(r0)
    assert res.timings["train_s"] > 0 and res.timings["serve_s"] > 0
    assert res.schedule == "sequential" and res.device == "cpu"

    # publication is read-only: the same weight stream as plain training
    ref = tapi.fit(cfg, task, device="cpu")
    assert pff_exec.params_bit_equal(ref.params, res.fit.params)
    assert res.fit.serve is res
    assert res.fit.test_acc == ref.test_acc


def test_train_while_serve_matches_reference():
    """All-Layers on 2 nodes (one device standing for both in the
    reference): the same swap timeline, and the trained params within
    the executor parity rule, from the reference's own draws."""
    d0 = jax.devices()[0]
    want = japi.serve(JConfig(**SMALL), jdata.mnist_like(n_train=512,
                                                         n_test=200),
                      traffic="uniform", schedule="all_layers",
                      num_nodes=2, devices=[d0] * 2, rate=2000.0, seed=0)
    cfg = TConfig(**SMALL)
    got = tapi.serve(cfg, tdata.mnist_like(n_train=512, n_test=200),
                     traffic="uniform", schedule="all_layers", num_nodes=2,
                     rate=2000.0, seed=0, device="cpu",
                     key=JaxKey(cfg.seed))
    versions = list(range(-1, cfg.splits))
    assert [s["version"] for s in got.swaps] == versions
    assert [s["version"] for s in want.swaps] == versions
    assert got.slo["consistency_violations"] == 0
    gp = params_to_numpy({"layers": got.fit.params["layers"]})
    wp = jax.tree_util.tree_map(np.asarray,
                                {"layers": want.fit.params["layers"]})
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(wp)):
        d = np.abs(a - b)
        assert float(d.max()) <= OUTLIER_TOL, float(d.max())
        assert (d > WEIGHT_TOL).sum() <= OUTLIER_SHARE * d.size
    assert got.fit.schedule == want.schedule == "all_layers"
    assert got.num_nodes == want.num_nodes == 2
    # the bus assembled the same snapshots from the same publications
    assert got.raw.bus_stats == want.raw.bus_stats


def test_fit_serve_runs_train_while_serve_and_publication_is_read_only():
    task = tdata.mnist_like(n_train=512, n_test=200)
    cfg = TConfig(**SMALL)
    fres = tapi.fit(cfg, task, backend="executor", schedule="all_layers",
                    num_nodes=2, device="cpu",
                    serve=tapi.ServeConfig(rate=2000.0, final_probe=32))
    assert isinstance(fres, tapi.FitResult) and fres.serve.fit is fres
    assert [s["version"] for s in fres.serve.swaps] == [-1, 0, 1, 2, 3]
    assert fres.serve.slo["consistency_violations"] == 0
    assert fres.serve.accuracy_by_version[3]["n"] >= 32
    plain = tapi.fit(cfg, task, backend="executor", schedule="all_layers",
                     num_nodes=2, device="cpu")
    assert pff_exec.params_bit_equal(plain.params, fres.params)
    assert fres.test_acc == plain.test_acc


def test_fit_rejects_serve_on_non_executor_backends():
    cfg = TConfig(layer_sizes=(784, 32), epochs=2, splits=2,
                  neg_mode="random", classifier="goodness", batch_size=64,
                  seed=0)
    with pytest.raises(ValueError, match="executor"):
        tapi.fit(cfg, None, backend="sequential", serve=tapi.ServeConfig(),
                 device="cpu")
    with pytest.raises(TypeError, match="ServeConfig"):
        tapi.fit(cfg, None, backend="executor", serve={"rate": 100},
                 device="cpu")
    with pytest.raises(ValueError, match="task or"):
        tapi.serve(cfg, device="cpu")
    with pytest.raises(TypeError, match="knob"):
        tapi.serve(cfg, tdata.mnist_like(n_train=64, n_test=32),
                   bogus_knob=3, device="cpu")
    with pytest.raises(ValueError, match="needs the training task"):
        tapi.serve(cfg, source=tdata.source_of(
            tdata.mnist_like(n_train=64, n_test=32)), device="cpu")


def test_training_error_is_reraised_not_swallowed():
    """A trainer that dies mid-run stops the loop (it probes what was
    published) and its exception reaches the caller."""
    task = tdata.mnist_like(n_train=64, n_test=64)
    cfg = TConfig(layer_sizes=(784, 16), epochs=2, splits=2,
                  neg_mode="random", classifier="goodness", batch_size=64,
                  seed=0)
    ex = pff_exec.PFFExecutor(cfg, task, "sequential", 1, device="cpu")
    real = ex._train_task

    def dying(k, chapter, *a):
        if chapter == 1:
            raise RuntimeError("node lost")
        return real(k, chapter, *a)

    ex._train_task = dying
    with pytest.raises(RuntimeError, match="node lost"):
        engine.train_while_serve(ex, engine.ServeConfig(rate=2000.0,
                                                        final_probe=8))


def test_kernel_counters_stay_exact_across_threads():
    counter = counts.Counter()
    n, per = 8, 5000

    def work():
        for _ in range(per):
            counter.bump()

    threads = [threading.Thread(target=work, name=f"t{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.total == n * per
    assert counter.by_thread == {f"t{i}": per for i in range(n)}
    mod = types.SimpleNamespace(LAUNCHES=counter)
    counts.reset(mod)
    assert counter.total == 0 and counter.by_thread == {}


def test_cpu_serving_has_no_stream_and_no_fences():
    assert engine.serve_stream("cpu") is None
    bus = engine.WeightBus(1)
    bus.publish_all(0, {"layers": [{"w": torch.ones(2, 2),
                                    "b": torch.zeros(2)}]})
    assert bus.fences(0) == []
    assert bus.next_snapshot(-1)[0] == 0


def test_cli_ff_mode_on_the_cpu(capsys):
    assert tserve.main(["--mode", "ff", "--device", "cpu", "--epochs", "8",
                        "--splits", "2", "--width", "64", "--n-train",
                        "512", "--nodes", "2", "--rate", "2000"]) == 0
    out = capsys.readouterr().out
    assert "train-while-serve: schedule=all_layers nodes=2" in out
    assert "violations=0" in out and "version   1:" in out
