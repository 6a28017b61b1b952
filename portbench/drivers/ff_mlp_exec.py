"""Driver ``ff_mlp_exec``: the paper's FF MLP trained by chapters through
the real executor, ``pff_exec.PFFExecutor``, one node a card.

The executor is built once, from the seed: the benchmark's weights in
the program's layout (``params=``), the seed's key, node i on
``cuda:i`` (``num_nodes`` of the traffic file), its schedule
(``all_layers``: chapter c on node c mod N, each node training every
layer of its chapters). Each call of ``run(carry=True)`` continues from
the state the last one left, so the training object passes from set-up
to the window through the executor itself; a ``chapter`` here is one
such call of ``chapters_per_call`` chapters, in which the executor may
overlap what the schedule lets it.

Set-up makes the window's call once, ``run(chapters=chapters_per_call,
carry=True)``, with the chapters handed from card to card inside it as
the window's calls hand them, and keeps what the comparison reads as
``drivers/ff_mlp_chapters.py`` keeps it: each leaf's gradient as Adam's
first moment holds it after the first chapter, the negatives' labels
after each chapter (both copied between chapters, ``state(copy=True)``
from the executor's ``after_chapter`` hook), the leaves after the last.
The reference follows those ``chapters_per_call`` chapters.
"""
from __future__ import annotations

import inspect
import time

import torch

from portbench.drivers import ff_mlp_chapters as seq
from portbench.lib import traffic as traffic_lib, weights
from portbench.lib.tracing import task_span
from portbench.reference import ff_mlp as ref


class Session:
    """The executor of one run, and its calls."""

    unit = "samples"

    def __init__(self, cell, seed, device, spans):
        from repro_torch import data as data_lib
        from repro_torch.core import pff_exec
        from repro_torch.core.rng import TorchKey

        takes = inspect.signature(pff_exec.PFFExecutor.run).parameters
        if "carry" not in takes or "after_chapter" not in takes:
            raise RuntimeError("PFFExecutor.run cannot continue from the "
                               "state of its last run, or keep a chapter's "
                               "(no carry= or after_chapter=)")
        config, traffic = cell["config"], cell["traffic"]
        self.spans = spans
        self.cfg = cfg = seq._config(config, traffic, seed)
        n_nodes = traffic["num_nodes"]
        if device.type == "cuda":
            if torch.cuda.device_count() < n_nodes:
                raise RuntimeError(f"{n_nodes} nodes need {n_nodes} CUDA "
                                   f"cards, found "
                                   f"{torch.cuda.device_count()}")
            devices = [torch.device("cuda", i) for i in range(n_nodes)]
        else:
            devices = [device] * n_nodes
        t0 = time.perf_counter()
        self.data = traffic_lib.make(traffic["data"], seed)
        x, y = self.data["x"], self.data["y"]
        task = data_lib.ImageTask(x, y, x[:0], y[:0], cfg.num_classes,
                                  x.shape[1])
        self.stages = {"inputs_s": time.perf_counter() - t0}
        params = {"layers": weights.ff_mlp(cfg.layer_sizes, seed, devices[0]),
                  "head": {"w": torch.zeros(sum(cfg.layer_sizes[2:]),
                                            cfg.num_classes,
                                            device=devices[0]),
                           "b": torch.zeros(cfg.num_classes,
                                            device=devices[0])}}
        self.ex = pff_exec.PFFExecutor(cfg, task, traffic["schedule"],
                                       n_nodes, devices=devices,
                                       key=TorchKey(seed), params=params)
        del params
        self.per_call = traffic["chapters_per_call"]
        n = x.shape[0]
        self.samples = -(-n // cfg.batch_size) * cfg.batch_size * max(
            cfg.epochs // cfg.splits, 1)
        kept = {}

        def keep(c):
            kept[c] = self.ex.state(copy=True)

        t0 = time.perf_counter()
        with task_span(self.spans, "run"):
            self.ex.run(chapters=self.per_call, carry=True, evaluate=False,
                        after_chapter=keep)
        self.readings = {
            "grad1": self._leaves(kept[0]["opt"]["layers"], "m",
                                  1.0 / (1 - ref.B1)),
            "labels": [kept[c]["neg"][:, :cfg.num_classes].argmax(1).to(
                "cpu", copy=True) for c in range(self.per_call)],
            "params": self._leaves(self.ex.state()["params"]["layers"])}
        kept.clear()
        self.stages["first_chapters_s"] = time.perf_counter() - t0

    @staticmethod
    def _leaves(layers, key=None, scale=1.0):
        return {f"{k}.{n}": ((lp if key is None else lp[key])[n] * scale
                             ).to("cpu", copy=True)
                for k, lp in enumerate(layers) for n in ("w", "b")}

    def chapter(self):
        """``chapters_per_call`` chapters in one executor run; returns
        the positive samples that completed a layer's grad step, summed
        over the layers over their number."""
        with task_span(self.spans, "run"):
            self.ex.run(chapters=self.per_call, carry=True, evaluate=False)
        return self.samples * self.per_call

    def free(self):
        self.ex = None


numbers = seq.numbers


def follow(cell, seed, device, readings, data, *, precision="f32",
           half_batch=False):
    """The reference over the same inputs, from the seed, for the
    ``chapters_per_call`` chapters of set-up's call."""
    layers = weights.ff_mlp(cell["config"]["layer_sizes"], seed, device)
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], device=device)
    out = ref.follow(x, y, layers, seq._run_dict(cell), seed,
                     cell["traffic"]["chapters_per_call"],
                     precision=precision, half_batch=half_batch)
    out["start"] = {f"{k}.{n}": lp[n] for k, lp in enumerate(layers)
                    for n in ("w", "b")}
    return out


def control_readings(cell, seed, device, readings, data, mode):
    """The reference put in the program's place: ``tf32`` (the control)
    or ``half_batch`` (a planted fault)."""
    return follow(cell, seed, device, readings, data, **seq.CONTROLS[mode])


def check(cell, seed, device, readings, data):
    """The cell's numbers for the program's readings."""
    return numbers(readings, follow(cell, seed, device, readings, data))
