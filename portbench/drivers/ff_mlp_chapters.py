"""Driver ``ff_mlp_chapters``: the paper's FF MLP trained by chapters.

The program's training object is built once, from the seed: the
benchmark's weights in the program's layout, the program's Adam state
(``ff_mlp.opt_init``) and its per-task functions. A chapter is
``pff.run_chapter_schedule``'s chapter body, call for call: each
layer's ``train_chapter`` of the goodness strategy, ``ff_mlp.fwd_norm``
to the next layer, then AdaptiveNEG's scoring
(``pff._class_scores_chunked``) and ``neg.fn``, with the host waiting
for the card after every task as that trainer does. ``run_chapter_
schedule`` and ``api.fit`` make their own weights and return no Adam
state, so the object could not pass from set-up to the window through
them.

Set-up runs the first ``PROVE`` chapters, keeping what the comparison
reads (each leaf's gradient as Adam's first moment holds it after the
first chapter, the leaves after the last, the negatives' labels after
each); the window runs the chapters after them.
"""
from __future__ import annotations

import time

import torch

from portbench.lib import compare, traffic as traffic_lib, weights
from portbench.lib.tracing import task_span
from portbench.reference import ff_mlp as ref

PROVE = 3      # chapters that set-up runs and the reference follows


def _config(config, traffic, seed):
    from repro_torch.configs.ff_mlp import FFMLPConfig

    keys = ("num_classes", "theta", "lr_ff", "lr_softmax", "epochs",
            "splits", "cooldown_after", "neg_mode", "classifier",
            "goodness_fn", "peer_w")
    return FFMLPConfig(layer_sizes=tuple(config["layer_sizes"]),
                       batch_size=traffic["batch"], seed=seed,
                       **{k: config[k] for k in keys})


class Session:
    """The training object of one run, and its chapters."""

    unit = "samples"

    def __init__(self, cell, seed, device, spans):
        from repro_torch.core import ff, ff_mlp, pff, strategies
        from repro_torch.core.rng import TorchKey

        self._ff_mlp, self._pff = ff_mlp, pff
        config, traffic = cell["config"], cell["traffic"]
        self.device, self.spans = device, spans
        self.cfg = cfg = _config(config, traffic, seed)
        self.good = strategies.goodness.get(cfg.goodness_fn)
        self.neg = strategies.negatives.get(cfg.neg_mode)
        if strategies.classifier.get(cfg.classifier).trains_head:
            raise NotImplementedError("a classifier with a softmax head")
        t0 = time.perf_counter()
        self.data = traffic_lib.make(traffic["data"], seed)
        self.stages = {"inputs_s": time.perf_counter() - t0}
        self.params = {"layers": weights.ff_mlp(cfg.layer_sizes, seed,
                                                device), "head": {
            "w": torch.zeros(sum(cfg.layer_sizes[2:]), cfg.num_classes,
                             device=device),
            "b": torch.zeros(cfg.num_classes, device=device)}}
        self.opt = ff_mlp.opt_init(self.params)
        self.key = TorchKey(seed)
        self.kneg = self.key.fold_in(999)
        self.C = max(cfg.epochs // cfg.splits, 1)
        self.impl = ff_mlp.kernel_impl(cfg)
        n = self.data["x"].shape[0]
        self.samples = -(-n // cfg.batch_size) * cfg.batch_size * self.C
        self.x = torch.as_tensor(self.data["x"], device=device)
        self.y = torch.as_tensor(self.data["y"], device=device)
        with torch.no_grad():
            self.xp0 = ff_mlp._norm(ff.overlay_label(self.x, self.y,
                                                     cfg.num_classes))
            self.xn0 = ff_mlp._norm(self.neg.fn(self.kneg, cfg, None, self.x,
                                                self.y, None))
        self.chapter_no = 0
        self.readings = {"grad1": {}, "labels": []}
        t0 = time.perf_counter()
        for _ in range(PROVE):
            self.chapter(record=True)
        self.stages["first_chapters_s"] = time.perf_counter() - t0
        self.readings["params"] = self._leaves(lambda k: self.params[
            "layers"][k])

    def _leaves(self, get, scale=1.0):
        return {f"{k}.{n}": (get(k)[n] * scale).to("cpu", copy=True)
                for k in range(len(self.params["layers"])) for n in ("w", "b")}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chapter(self, record=False):
        """One chapter of the schedule; returns the positive samples that
        completed a grad step, summed over the layers over their number."""
        cfg, good, c = self.cfg, self.good, self.chapter_no
        from repro_torch import optim

        lrs = torch.stack([optim.cooldown_lr(cfg.lr_ff, c * self.C + e,
                                             cfg.epochs, cfg.cooldown_after)
                           for e in range(self.C)])
        kc = self.key.fold_in(c)
        acts = (self.xp0, self.xn0)
        n_layers = len(self.params["layers"])
        for k in range(n_layers):
            with task_span(self.spans, "train"):
                state = good.train_chapter(
                    good.get_state(self.params, self.opt, k), acts, (), lrs,
                    kc.fold_in(k), cfg=cfg, epochs=self.C)
                good.set_state(self.params, self.opt, k, state)
                if k + 1 < n_layers:
                    with torch.no_grad():
                        acts = tuple(self._ff_mlp.fwd_norm(state[0], a,
                                                           impl=self.impl)
                                     for a in acts)
                self._sync()
        if record and c == 0:
            # Adam's first moment after the first chapter, over 1 - b1:
            # the first gradient where a chapter is one grad step
            self.readings["grad1"] = self._leaves(
                lambda k: self.opt["layers"][k]["m"], 1.0 / (1 - ref.B1))
        if good.uses_negatives and self.neg.regenerates:
            with task_span(self.spans, "neg_gen"), torch.no_grad():
                scores = None
                if self.neg.needs_scores:
                    scores = self._pff._class_scores_chunked(self.params,
                                                             self.x, cfg)
                self.xn0 = self._ff_mlp._norm(self.neg.fn(
                    self.kneg.fold_in(c), cfg,
                    self.params if self.neg.needs_scores else None,
                    self.x, self.y, scores))
                self._sync()
            if record:
                self.readings["labels"].append(
                    self.xn0[:, :cfg.num_classes].argmax(1).to("cpu", copy=True))
        self.chapter_no += 1
        return self.samples

    def free(self):
        for name in ("params", "opt", "x", "y", "xp0", "xn0"):
            setattr(self, name, None)


def _run_dict(cell):
    return {**cell["config"], "batch": cell["traffic"]["batch"]}


def follow(cell, seed, device, readings, data, *, precision="f32",
           half_batch=False):
    """The reference over the same inputs, from the seed."""
    layers = weights.ff_mlp(cell["config"]["layer_sizes"], seed, device)
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], device=device)
    out = ref.follow(x, y, layers, _run_dict(cell), seed, PROVE,
                     precision=precision, half_batch=half_batch)
    out["start"] = {f"{k}.{n}": lp[n] for k, lp in enumerate(layers)
                    for n in ("w", "b")}
    return out


def numbers(readings, reference):
    """The cell's numbers: the first gradient's and the change's gap by
    the worst leaf, and the share of negatives whose label differs."""
    grad = compare.worst_leaf_gap(readings["grad1"], reference["grad1"])
    keep = compare.moved(reference["grad1"])
    start = reference["start"]
    chg = compare.worst_leaf_gap(
        compare.change(readings["params"], start),
        compare.change(reference["params"], start), keep)
    labels = max(float((p.to(r.device) != r).float().mean())
                 for p, r in zip(readings["labels"], reference["labels"]))
    return {"grad_gap": grad, "change_gap": chg, "label_mismatch": labels}


CONTROLS = {"tf32": {"precision": "tf32"}, "half_batch": {"half_batch": True}}


def control_readings(cell, seed, device, readings, data, mode):
    """The reference put in the program's place: ``tf32`` (the control)
    or ``half_batch`` (a planted fault)."""
    return follow(cell, seed, device, readings, data, **CONTROLS[mode])


def check(cell, seed, device, readings, data):
    """The cell's numbers for the program's readings."""
    return numbers(readings, follow(cell, seed, device, readings, data))
