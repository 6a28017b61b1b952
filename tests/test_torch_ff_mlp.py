"""The port's FF-MLP prediction slice against the reference: the same
parameters (the reference's ``ff_mlp.init``, carried over with
``convert.params_from_numpy``) and the same inputs give the same class
scores under all four classifiers, the same predictions and accuracy;
the port's own ``init`` builds the reference's tree; one chapter of each
goodness strategy trains as the reference's does; the FF primitives and
strategy registries match."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro.core import ff as jff, ff_mlp as jmlp, strategies as jstrat
from repro_torch import data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ff as tff, ff_mlp as tmlp, strategies as tstrat

from repro_torch.core.rng import TorchKey

from test_torch_train import JaxKey

SIZES = (784, 64, 48, 32)
RTOL = 1e-5
CLASSIFIERS = [("goodness", "sumsq"), ("softmax", "sumsq"),
               ("perf_opt_all", "perf_opt"), ("perf_opt_last", "perf_opt")]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init for each goodness strategy, as numpy. (The
    sumsq tree is the perf_opt tree without the §4.4 local heads: one
    reference init serves both.)"""
    init = jax.jit(jmlp.init, static_argnums=1)     # one compile, not many
    po = jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(3), JConfig(layer_sizes=SIZES,
                                       goodness_fn="perf_opt")))
    return {"perf_opt": po,
            "sumsq": {k: v for k, v in po.items() if k != "local_heads"}}


@pytest.fixture(scope="module")
def task():
    return tdata.mnist_like(seed=0, n_train=32, n_test=96)


def _assert_scores_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("mode,good", CLASSIFIERS)
@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
def test_class_scores_match_reference(ref_params, task, mode, good, jimpl):
    x = task.x_test[:32]
    want = np.asarray(jmlp.class_scores(
        jax.tree_util.tree_map(jnp.asarray, ref_params[good]),
        jnp.asarray(x), 10, mode, impl=jimpl))
    got = tmlp.class_scores(params_from_numpy(ref_params[good], "cpu"),
                            torch.as_tensor(x), 10, mode)
    assert got.shape == (32, 10) and got.dtype == torch.float32
    _assert_scores_close(got.numpy(), want)


@pytest.mark.parametrize("mode,good", CLASSIFIERS)
def test_predict_and_accuracy_match_reference(ref_params, task, mode,
                                              good):
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params[good])
    tp = params_from_numpy(ref_params[good], "cpu")
    want_pred = np.asarray(jmlp.predict(jp, jnp.asarray(task.x_test), 10,
                                        mode, impl="ref"))
    got_pred = tmlp.predict(tp, torch.as_tensor(task.x_test), 10, mode)
    np.testing.assert_array_equal(got_pred.numpy(), want_pred)
    want = jmlp.accuracy(jp, task.x_test, task.y_test, 10, mode, chunk=40,
                         impl="ref")
    got = tmlp.accuracy(tp, task.x_test, task.y_test, 10, mode, chunk=40)
    assert got == pytest.approx(want, abs=1e-7)


@pytest.mark.parametrize("good", ["sumsq", "perf_opt"])
def test_init_builds_the_reference_tree(ref_params, good):
    got = params_to_numpy(tmlp.init(
        TConfig(layer_sizes=SIZES, goodness_fn=good),
        torch.Generator().manual_seed(0), "cpu"))
    want = ref_params[good]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    for lp, k in zip(got["layers"], SIZES):
        assert np.all(lp["b"] == 0)
        assert abs(lp["w"].std() * k ** 0.5 - 1.0) < 0.1   # N(0, 1/K)


@pytest.mark.parametrize("good", ["sumsq", "perf_opt"])
def test_init_from_a_key_splits_it_as_the_reference_does(good):
    """Given the reference's key (through ``JaxKey``), the port's init
    draws the reference's eager ``init`` bit for bit (the jitted one
    may fuse the scaling and round the last bit differently)."""
    got = params_to_numpy(tmlp.init(
        TConfig(layer_sizes=SIZES, goodness_fn=good),
        JaxKey(jax.random.PRNGKey(3)), "cpu"))
    want = jax.tree_util.tree_map(np.asarray, jmlp.init(
        jax.random.PRNGKey(3), JConfig(layer_sizes=SIZES,
                                       goodness_fn=good)))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = tmlp.init(TConfig(layer_sizes=SIZES, goodness_fn=good),
                    TorchKey(3), "cpu")
    assert torch.equal(own["layers"][0]["w"], tmlp.init(
        TConfig(layer_sizes=SIZES, goodness_fn=good), TorchKey(3),
        "cpu")["layers"][0]["w"])


def test_init_is_a_function_of_the_generator():
    cfg = TConfig(layer_sizes=SIZES)
    a = tmlp.init(cfg, torch.Generator().manual_seed(7), "cpu")
    b = tmlp.init(cfg, torch.Generator().manual_seed(7), "cpu")
    c = tmlp.init(cfg, torch.Generator().manual_seed(8), "cpu")
    assert torch.equal(a["layers"][0]["w"], b["layers"][0]["w"])
    assert not torch.equal(a["layers"][0]["w"], c["layers"][0]["w"])


def test_params_round_trip_through_numpy(ref_params):
    for good in ("sumsq", "perf_opt"):
        back = params_to_numpy(params_from_numpy(ref_params[good], "cpu"))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(ref_params[good])):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ff_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = rng.random((6, 20)).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    dist = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    tx = torch.as_tensor(x)
    pairs = [
        (tff.overlay_label(tx, torch.as_tensor(labels), 5),
         jff.overlay_label(jnp.asarray(x), jnp.asarray(labels), 5)),
        (tff.overlay_label(tx, torch.as_tensor(dist), 5),
         jff.overlay_label(jnp.asarray(x), jnp.asarray(dist), 5)),
        (tff.overlay_neutral(tx, 5), jff.overlay_neutral(jnp.asarray(x), 5)),
        (tff.goodness(tx), jff.goodness(jnp.asarray(x))),
        (tff.mean_goodness(tx), jff.mean_goodness(jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_registries_match_reference_names():
    assert tstrat.classifier.names() == jstrat.classifier.names()
    assert tstrat.goodness.names() == jstrat.goodness.names()
    assert tstrat.negatives.names() == jstrat.negatives.names()
    for name in tstrat.negatives.names():
        t, j = tstrat.negatives.get(name), jstrat.negatives.get(name)
        assert (t.regenerates, t.needs_scores) == (j.regenerates,
                                                   j.needs_scores)
    for name in tstrat.classifier.names():
        t, j = tstrat.classifier.get(name), jstrat.classifier.get(name)
        assert (t.trains_head, t.requires_goodness) == (
            j.trains_head, j.requires_goodness)
    for cls in ("goodness", "softmax"):
        for good in ("sumsq", "perf_opt"):
            tcfg = TConfig(classifier=cls, goodness_fn=good)
            jcfg = JConfig(classifier=cls, goodness_fn=good)
            assert (tstrat.goodness.get(good).eval_mode(tcfg)
                    == jstrat.goodness.get(good).eval_mode(jcfg))
    with pytest.raises(KeyError, match="registered: goodness"):
        tstrat.classifier.get("nope")


@pytest.mark.parametrize("good", ["sumsq", "perf_opt"])
def test_chapter_training_matches_reference(good, ref_params):
    """One ``train_chapter`` of each goodness strategy, through the
    registries, from the reference's params and with the reference's
    random draws (``JaxKey``): the layer's state after the chapter
    agrees within the reference's ref-vs-fused gate (1e-4 max-abs)."""
    jcfg = JConfig(layer_sizes=SIZES, goodness_fn=good, batch_size=32)
    tcfg = TConfig(layer_sizes=SIZES, goodness_fn=good, batch_size=32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((96, SIZES[0]))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    if good == "sumsq":
        xn = rng.standard_normal((96, SIZES[0]))
        xn = (xn / np.linalg.norm(xn, axis=1, keepdims=True)).astype(
            np.float32)
        acts, extras = (x, xn), ()
    else:
        acts, extras = (x,), (rng.integers(0, 10, 96).astype(np.int32),)
    lrs = np.full(2, 0.01, np.float32)
    key = jax.random.PRNGKey(9)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params[good])
    jstrat_good = jstrat.goodness.get(good)
    want = jstrat_good.train_chapter(
        jstrat_good.get_state(jp, jmlp.opt_init(jp), 0),
        tuple(map(jnp.asarray, acts)), tuple(map(jnp.asarray, extras)),
        jnp.asarray(lrs), key, cfg=jcfg, epochs=2)
    tp = params_from_numpy(ref_params[good], "cpu")
    tstrat_good = tstrat.goodness.get(good)
    got = tstrat_good.train_chapter(
        tstrat_good.get_state(tp, tmlp.opt_init(tp), 0),
        tuple(map(torch.tensor, acts)), tuple(map(torch.tensor, extras)),
        torch.tensor(lrs), JaxKey(key), cfg=tcfg, epochs=2)
    assert len(got) == len(want)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        assert float(np.abs(a - np.asarray(b)).max()) <= 1e-4
    assert not np.array_equal(params_to_numpy(got[0])["w"],
                              ref_params[good]["layers"][0]["w"])


def test_data_tasks_feed_both_packages_alike():
    """The slice test's inputs are the port's own mnist_like; they are
    the reference's arrays bit for bit (so the comparisons above hold
    for the reference's data too)."""
    t, j = tdata.mnist_like(seed=0, n_train=32, n_test=96), \
        jdata.mnist_like(seed=0, n_train=32, n_test=96)
    assert np.array_equal(t.x_test, j.x_test)
    assert np.array_equal(t.y_test, j.y_test)
