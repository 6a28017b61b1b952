"""The port's ``checkpoint`` module on the CPU: bit-exact round trips,
its refusals, atomic writes and the meta block, and files crossing
between the two packages both ways, including a PFF chapter manifest
that the reference executor wrote, restored through the port
executor's own template."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as japi, checkpoint as jckpt, data as jdata
from repro.configs.ff_mlp import FFMLPConfig as JConfig
from repro.core import faults as jfaults
from repro_torch import checkpoint as ckpt, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig as TConfig
from repro_torch.core import pff_exec

SIZES = (784, 128, 128)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"states": [({"w": torch.randn(3, 4, generator=g),
                         "b": torch.randn(4, generator=g)},
                        {"m": {"w": torch.randn(3, 4, generator=g)},
                         "v": {"w": torch.rand(3, 4, generator=g)}})],
            "head": (torch.randn(5, generator=g).to(torch.bfloat16),
                     torch.arange(6, dtype=torch.int64)),
            "skip": None,
            "zeta": torch.randn(2, 2, generator=g)}


def _like(tree):
    return {"states": [({"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                        {"m": {"w": torch.zeros(3, 4)},
                         "v": {"w": torch.zeros(3, 4)}})],
            "head": (torch.zeros(5, dtype=torch.bfloat16),
                     torch.zeros(6, dtype=torch.int64)),
            "skip": None,
            "zeta": torch.zeros(2, 2)}


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal_trees(x, y) for x, y in zip(a, b)))
    if a is None:
        return b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def test_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.npz")
    ckpt.save(path, tree, step=7)
    got, step = ckpt.restore(path, _like(tree))
    assert step == 7 and _equal_trees(got, tree)
    # keys are the reference's path strings, dict keys sorted
    with np.load(path) as z:
        assert sorted(z.files) == sorted([
            "states/0/0/b", "states/0/0/w", "states/0/1/m/w",
            "states/0/1/v/w", "head/0", "head/1", "zeta", "__step__"])
        assert z["head/0"].dtype == np.float32      # bf16 stored upcast


def test_refuses_missing_key_wrong_shape_and_strict_extras(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(KeyError, match="checkpoint missing c"):
        ckpt.restore(path, {"a": torch.zeros(2), "c": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {"a": torch.zeros(4), "b": torch.zeros(3)})
    # lenient by default, strict refuses what the template leaves unread
    got, _ = ckpt.restore(path, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.ones(2))
    with pytest.raises(ValueError, match="did not consume: b"):
        ckpt.restore(path, {"a": torch.zeros(2)}, strict=True)
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save(path, {"__meta__": torch.ones(1)})


def test_writes_are_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "t.npz")
    ckpt.save(path, {"a": torch.ones(2)})
    assert os.listdir(tmp_path / "sub") == ["t.npz"]

    def broken(f, **arrays):
        f.write(b"half an archive")
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(path, {"a": torch.zeros(2)})
    monkeypatch.undo()
    got, _ = ckpt.restore(path, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.ones(2))     # the old file survives


def test_meta_round_trip(tmp_path):
    path = str(tmp_path / "t.npz")
    meta = {"chapter": 3, "schedule": "all_layers", "ver": [1, 2],
            "layer_sizes": list(SIZES)}
    ckpt.save(path, {"a": torch.ones(2)}, step=3, meta=meta)
    _, step, got = ckpt.restore(path, {"a": torch.zeros(2)},
                                with_meta=True)
    assert step == 3 and got == meta
    ckpt.save(path, {"a": torch.ones(2)})
    assert ckpt.restore(path, {"a": torch.zeros(2)},
                        with_meta=True)[1:] == (None, None)
    with pytest.raises(TypeError):
        ckpt.save(path, {"a": torch.ones(2)}, meta={"x": object()})


def test_restore_lands_on_the_templates_dtype(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, {"a": torch.tensor([1.5, -2.25])})
    got, _ = ckpt.restore(path, {"a": torch.zeros(2, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64
    assert got["a"].tolist() == [1.5, -2.25]


def _jax_tree(tree):
    """The same tree as the reference holds it: jax arrays, bf16 as
    ml_dtypes, tuples kept, None kept."""
    def conv(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return jax.tree_util.tree_map(conv, tree, is_leaf=lambda x: x is None)


def test_reference_files_and_port_files_cross_both_ways(tmp_path):
    tree = _tree(seed=3)
    jtree = _jax_tree(tree)
    meta = {"chapter": 1}
    # port -> reference
    p1 = str(tmp_path / "port.npz")
    ckpt.save(p1, tree, step=2, meta=meta)
    got, step, m = jckpt.restore(p1, jtree, strict=True, with_meta=True)
    assert step == 2 and m == meta
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))
    # reference -> port
    p2 = str(tmp_path / "ref.npz")
    jckpt.save(p2, jtree, step=2, meta=meta)
    back, step, m = ckpt.restore(p2, _like(tree), strict=True,
                                 with_meta=True)
    assert step == 2 and m == meta and _equal_trees(back, tree)
    # the two files hold the same keys and bits
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("neg_mode,classifier", [("random", "goodness"),
                                                 ("adaptive", "softmax")])
def test_reference_chapter_manifest_restores_into_the_port_template(
        tmp_path, neg_mode, classifier):
    """A manifest the reference executor wrote (in-process, one device
    standing for N nodes) restores through the port executor's own
    template with strict=True, leaf for leaf equal to the reference's
    final states, and carries the meta the port checks on resume."""
    kw = dict(layer_sizes=SIZES, epochs=4, splits=2, neg_mode=neg_mode,
              classifier=classifier, batch_size=64, seed=0)
    jtask = jdata.mnist_like(n_train=520, n_test=50)
    d0 = jax.devices()[0]
    rc = jfaults.ResilienceConfig(checkpoint_dir=str(tmp_path))
    jres = japi.fit(JConfig(**kw), jtask, backend="executor",
                    schedule="all_layers", num_nodes=2, devices=[d0, d0],
                    resilience=rc)
    path = pff_exec.checkpoint_path(str(tmp_path), 1)
    assert pff_exec.latest_checkpoint(str(tmp_path)) == path
    ex = pff_exec.PFFExecutor(TConfig(**kw),
                              tdata.mnist_like(n_train=520, n_test=50),
                              "all_layers", 2, device="cpu")
    tree, step, meta = ckpt.restore(path, ex._ckpt_template(), strict=True,
                                    with_meta=True)
    assert step == 1 and meta["chapter"] == 1
    assert meta["schedule"] == "all_layers" and meta["num_nodes"] == 2
    for k, lp in enumerate(jres.params["layers"]):
        for name in ("w", "b"):
            assert np.array_equal(tree["states"][k][0][name].numpy(),
                                  np.asarray(lp[name]))
    if classifier == "softmax":
        assert np.array_equal(tree["head"][0]["w"].numpy(),
                              np.asarray(jres.params["head"]["w"]))
    assert ("neg" in tree) == (neg_mode == "adaptive")
