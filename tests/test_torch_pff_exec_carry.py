"""``PFFExecutor.run(carry=True)``: chapters run over several calls, each
continuing from the state the last one left, are the schedule's one run
bit for bit; ``params=`` sets the initial params; without ``carry``
every run starts from them again, as before."""
import dataclasses

import pytest
import torch

from repro_torch import data
from repro_torch.configs.ff_mlp import PAPER_MLP
from repro_torch.core import ff_mlp, pff_exec
from repro_torch.core.rng import TorchKey

CFG = dataclasses.replace(PAPER_MLP, layer_sizes=(784, 48, 48, 48),
                          epochs=6, splits=6, batch_size=128, seed=3)


@pytest.fixture(scope="module")
def task():
    return data.mnist_like(n_train=384, n_test=64)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("schedule,nodes", [("all_layers", 4),
                                            ("single_layer", 2),
                                            ("sequential", 1)])
def test_carried_calls_are_one_run_bit_for_bit(task, schedule, nodes):
    whole = pff_exec.PFFExecutor(CFG, task, schedule, nodes,
                                 device="cpu").run()
    ex = pff_exec.PFFExecutor(CFG, task, schedule, nodes, device="cpu")
    for n in (1, 2, 3):
        res = ex.run(chapters=n, carry=True, evaluate=False)
    assert res.test_acc is None and ex.state()["next_chapter"] == 6
    assert pff_exec.params_bit_equal(whole.params, res.params,
                                     with_head=True)
    st = ex.state()
    assert all(torch.equal(a, b) for a, b in zip(
        (lp["w"] for lp in st["params"]["layers"]),
        (lp["w"] for lp in res.params["layers"])))


def test_params_set_the_start_and_runs_without_carry_restart(task):
    params = ff_mlp.init(CFG, TorchKey(99), "cpu")
    ex = pff_exec.PFFExecutor(CFG, task, "all_layers", 2, device="cpu",
                              params=params)
    a = ex.run(chapters=2)
    b = ex.run(chapters=2)
    assert pff_exec.params_bit_equal(a.params, b.params, with_head=True)
    assert ex.state()["next_chapter"] == 2
    other = pff_exec.PFFExecutor(CFG, task, "all_layers", 2,
                                 device="cpu").run(chapters=2)
    assert not pff_exec.params_bit_equal(a.params, other.params)
    assert torch.equal(params["layers"][0]["w"],
                       ff_mlp.init(CFG, TorchKey(99), "cpu")["layers"][0]["w"])


def test_a_count_may_run_past_the_splits(task):
    ex = pff_exec.PFFExecutor(CFG, task, "all_layers", 2, device="cpu")
    ex.run(chapters=5, carry=True, evaluate=False)
    ex.run(chapters=3, carry=True, evaluate=False)
    assert ex.state()["next_chapter"] == 8


def test_a_hook_between_chapters_keeps_each_chapters_state(task):
    """``state(copy=True)`` inside ``after_chapter`` holds the chapter's
    layers, Adam moments and negatives as a run that stops there leaves
    them, while the run goes on and trains past them."""
    seen = {}
    ex = pff_exec.PFFExecutor(CFG, task, "all_layers", 4, device="cpu")
    ex.run(chapters=3, carry=True, evaluate=False,
           after_chapter=lambda c: seen.setdefault(c, ex.state(copy=True)))
    assert sorted(seen) == [0, 1, 2]
    step = pff_exec.PFFExecutor(CFG, task, "all_layers", 4, device="cpu")
    for c in range(3):
        step.run(chapters=1, carry=True, evaluate=False)
        want = step.state()
        assert torch.equal(seen[c]["neg"], want["neg"])
        for got, exp in zip(seen[c]["opt"]["layers"],
                            want["opt"]["layers"]):
            assert torch.equal(got["m"]["w"], exp["m"]["w"])
        for got, exp in zip(seen[c]["params"]["layers"],
                            want["params"]["layers"]):
            assert torch.equal(got["w"], exp["w"])
    assert not torch.equal(seen[0]["params"]["layers"][0]["w"],
                           ex.state()["params"]["layers"][0]["w"])
