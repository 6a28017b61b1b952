"""Driver ``lm_chapters``: a dense transformer LM trained by FF chapters.

The program's training object is built once, from the seed: the
benchmark's weights in the program's tree layout, the program's Adam
state (``optim.adam_init``) and its per-task steps
(``pff_lm.make_block_step`` / ``make_head_step``). A chapter is
``pff_lm.train_chapters``' chapter body, call for call: block k's grad
steps for k = 0..L-1 with one global step counter, then the head task,
the host waiting for the card after each task and reading each block
task's last loss as that trainer does. ``train_chapters`` and
``api.fit`` return no Adam state, so the object could not pass from
set-up to the window through them.

Tokens come from the seed's Markov chain over the whole vocabulary: one
pool of (steps x (L + 1)) batches, on the card before the window; task
(c, k) takes batch (c + k) mod (L + 1) of it, so each task of a chapter
sees other rows.

Set-up runs the first chapter. It keeps what the comparison reads: the
first three block steps' losses, block 0's gradient as Adam's first
moment holds it after step 1, blocks 0-2 after step 3; and, for the head
task, every weight at its start (the reference follows the head from the
program's own state), its loss and its gradient of ``final_norm`` and
the tied table.
"""
from __future__ import annotations

import time

import torch

from portbench.lib import compare, traffic as traffic_lib, weights
from portbench.lib.tracing import task_span
from portbench.reference import lm as ref

PROVE = 3


def model_config(config):
    from repro_torch.configs.base import FFConfig, ModelConfig

    return ModelConfig(
        name=config["name"], arch_type="dense",
        num_layers=config["num_layers"], d_model=config["d_model"],
        n_heads=config["n_heads"], n_kv=config["n_kv"],
        d_ff=config["d_ff"], vocab=config["vocab"],
        head_dim=config["head_dim"], qkv_bias=True,
        rope_theta=config["rope_theta"], norm_eps=config["norm_eps"],
        tie_embeddings=True, dtype=config["dtype"],
        groups=((("attn",), config["num_layers"]),),
        ff=FFConfig(theta=config["theta"]))


def program_tree(w):
    """The program's params layout (``transformer.init``'s) over the
    benchmark's weights: the one group's stacked leaves."""
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "groups": (({"norm1": w["norm1"],
                         "attn": {"wq": w["wq"], "wk": w["wk"],
                                  "wv": w["wv"], "wo": w["wo"],
                                  "bq": w["bq"], "bk": w["bk"],
                                  "bv": w["bv"]},
                         "norm2": w["norm2"],
                         "mlp": {"wi": w["wi"], "wg": w["wg"],
                                 "wo": w["wo_mlp"]}},),)}


def flat(tree):
    """The benchmark's names over a program tree (views)."""
    g = tree["groups"][0][0]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "norm1": g["norm1"], "norm2": g["norm2"],
            **{k: g["attn"][k] for k in ("wq", "bq", "wk", "bk", "wv", "bv",
                                          "wo")},
            "wi": g["mlp"]["wi"], "wg": g["mlp"]["wg"],
            "wo_mlp": g["mlp"]["wo"]}


def _units(tree, j):
    f = flat(tree)
    return {f"{j}.{n}": f[n][j] for n in ref.BLOCK_LEAVES}


def _keep(t):
    """A host copy that later in-place updates cannot reach."""
    return t.detach().to("cpu", copy=True)


def make_data(cell, seed):
    t, c = cell["traffic"], cell["config"]
    rows = t["batch"] * t["steps_per_chapter"] * (c["num_layers"] + 1)
    return traffic_lib.make({**t["data"], "vocab": c["vocab"], "rows": rows,
                             "seq": t["seq"]}, seed)


class Session:
    unit = "tokens"

    def __init__(self, cell, seed, device, spans):
        from repro_torch import optim
        from repro_torch.core import pff_lm
        from repro_torch.core.rng import TorchKey

        config, traffic = cell["config"], cell["traffic"]
        self.device, self.spans = device, spans
        self.cfg = model_config(config)
        self.L = config["num_layers"]
        self.batch, self.steps = traffic["batch"], traffic["steps_per_chapter"]
        t0 = time.perf_counter()
        self.data = make_data(cell, seed)
        self.pool = torch.as_tensor(self.data["tokens"], device=device)
        self.stages = {"inputs_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.params = program_tree(weights.lm(config, seed, device))
        self.opt = optim.adam_init(self.params)
        lr = traffic["lr"]
        self.step = pff_lm.make_block_step(self.cfg, lr=lr, seed=seed,
                                           key_fn=TorchKey, impl="auto")
        self.head_step = pff_lm.make_head_step(self.cfg, head_lr=lr,
                                               impl="auto")
        self.tokens = self.batch * traffic["seq"] * self.steps
        self.n = self.n_head = 0
        self.chapter_no = 0
        self.readings = {}
        self.losses = []
        self._sync()
        self.stages["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.chapter(record=True)
        self.stages["first_chapter_s"] = time.perf_counter() - t0

    def _batch(self, c, k, s):
        j = ((c + k) % (self.L + 1)) * self.steps + s
        return {"tokens": self.pool[j * self.batch:(j + 1) * self.batch]}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _record_block(self, loss):
        r = self.readings
        r.setdefault("loss", []).append(float(loss))
        if self.n == 1:
            m = flat(self.opt["m"])
            r["grad1"] = {n: _keep(m[n][0] / (1 - ref.B1))
                          for n in ref.BLOCK_LEAVES}
        if self.n == PROVE:
            r["params"] = {k: _keep(v) for j in range(PROVE)
                           for k, v in _units(self.params, j).items()}
            r["batches"] = [_keep(self._batch(0, k, 0)["tokens"])
                            for k in range(PROVE)]

    def chapter(self, record=False):
        """One chapter; returns the tokens (positives) that completed a
        block's grad step, summed over the blocks over their number."""
        c = self.chapter_no
        record = record and self.steps == 1
        for k in range(self.L):
            with task_span(self.spans, "block"):
                last = None
                for s in range(self.steps):
                    self.n += 1
                    self.params, self.opt, last = self.step(
                        self.params, self.opt, self._batch(c, k, s), k, self.n)
                    if record and self.n <= PROVE:
                        self._record_block(last)
                self._sync()
                self.losses.append(float(last))
        if record:
            self.readings["head_state"] = {n: _keep(t) for n, t in
                                           flat(self.params).items()}
        with task_span(self.spans, "head"):
            for s in range(self.steps):
                self.n_head += 1
                hb = self._batch(c, self.L, s)
                self.params, self.opt, hloss = self.head_step(
                    self.params, self.opt, hb, self.n_head)
            self._sync()
        if record:
            m = flat(self.opt["m"])
            self.readings["head"] = {
                "loss": [float(hloss)],
                "grad1": {n: _keep(m[n] / (1 - ref.B1))
                          for n in ("final_norm", "embed")},
                "batch": _keep(hb["tokens"])}
        self.chapter_no += 1
        return self.tokens

    def free(self):
        self.params = self.opt = self.pool = None


def follow(cell, seed, device, readings, data, *, precision="f32",
           half_batch=False):
    """The reference: the first three block steps from the seed's
    weights, and the head step from the program's state at its start,
    over the batches the program took."""
    cfg = cell["config"]
    w = weights.lm(cell["config"], seed, device)
    batches = [b.to(device) for b in readings["batches"]]
    out = ref.follow_blocks(w, cfg, batches, seed, cell["traffic"]["lr"],
                            precision=precision, half_batch=half_batch)
    out["start"] = {f"{j}.{n}": w[n][j] for j in range(PROVE)
                    for n in ref.BLOCK_LEAVES}
    del w
    state = {n: t.to(device) for n, t in readings["head_state"].items()}
    out["head"] = ref.head_step(state, cfg, readings["head"]["batch"].to(
        device), precision=precision, half_batch=half_batch)
    return out


def numbers(readings, reference):
    """The cell's numbers: the three block steps' loss gap, block 0's
    first gradient and blocks 0-2's change by the worst leaf; the head
    step's loss gap and its gradient by the worst leaf."""
    keep_g = compare.moved(reference["grad1"])
    grad = compare.worst_leaf_gap(readings["grad1"], reference["grad1"],
                                  keep_g)
    moved = {f"{j}.{n}" for j in range(PROVE) for n in keep_g}
    start = reference["start"]
    chg = compare.worst_leaf_gap(
        compare.change(readings["params"], start),
        compare.change(reference["params"], start), moved)
    h, rh = readings["head"], reference["head"]
    return {"loss_gap": compare.loss_gap(readings["loss"], reference["loss"]),
            "grad_gap": grad, "change_gap": chg,
            "head_loss_gap": compare.loss_gap(h["loss"], rh["loss"]),
            "head_grad_gap": compare.worst_leaf_gap(h["grad1"],
                                                    rh["grad1"])}


CONTROLS = {"fp8": {"precision": "fp8"}, "half_batch": {"half_batch": True}}


def control_readings(cell, seed, device, readings, data, mode):
    """The reference put in the program's place, as the program's
    readings: ``fp8`` (the control) or ``half_batch`` (a planted
    fault)."""
    out = follow(cell, seed, device, readings, data, **CONTROLS[mode])
    return {"loss": out["loss"], "grad1": out["grad1"],
            "params": out["params"], "head": out["head"]}


def check(cell, seed, device, readings, data):
    """The cell's numbers for the program's readings."""
    return numbers(readings, follow(cell, seed, device, readings, data))
