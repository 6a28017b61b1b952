"""Driver ``mla_moe_chapters``: DeepSeek-V3's block (MLA, a dense layer,
then the sigmoid-routed MoE) trained by FF chapters on one card's share.

The program's configuration is its registered one
(``get_config(config["name"])``) with the cut of the configuration
file: its depth, the experts this card holds (``n_routed_experts`` of
``router_experts``, from ``expert_offset``) and the vocabulary slice;
every published width of the file is checked against it. The training
object is built once, from the seed: the benchmark's weights
(``lib/weights_mla_moe.py``) in the program's tree layout (two groups:
the dense layer, the MoE layers), the program's Adam state and its
per-task steps (``pff_lm.make_block_step`` / ``make_head_step``). A
chapter is ``pff_lm.train_chapters``' chapter body, call for call, as
``drivers/lm_chapters.py``'s is.

Tokens come from the seed's Markov chain over the slice: one pool of
(steps x (L + 1)) batches on the card; task (c, k) takes batch (c + k)
mod (L + 1).

Set-up runs the first chapter. It keeps what the comparison reads: the
first three block steps' losses, each of blocks 0-2's gradient as
Adam's first moment holds it after its step, blocks 0-2 and their
routers' biases after step 3, and every router call's choices in those
steps (``routes_noted``); for the head task, every weight at its start,
its loss, its gradient of ``final_norm`` and ``lm_head`` and its router
calls' choices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from portbench.lib import compare, traffic as traffic_lib
from portbench.lib import weights_mla_moe as wm
from portbench.lib.tracing import task_span
from portbench.reference import lm as lm_ref
from portbench.reference import mla_moe as ref

PROVE = 3
# the configuration file's published widths, and the registered
# config's field each must equal
WIDTHS = {"hidden_size": ("d_model",), "num_attention_heads": ("n_heads",),
          "intermediate_size": ("d_ff",), "rope_theta": ("rope_theta",),
          "rms_norm_eps": ("norm_eps",),
          "kv_lora_rank": ("mla", "kv_lora_rank"),
          "qk_nope_head_dim": ("mla", "qk_nope_head_dim"),
          "qk_rope_head_dim": ("mla", "qk_rope_head_dim"),
          "v_head_dim": ("mla", "v_head_dim"),
          "router_experts": ("moe", "num_experts"),
          "num_experts_per_tok": ("moe", "top_k"),
          "moe_intermediate_size": ("moe", "expert_ff"),
          "n_shared_experts": ("moe", "num_shared"),
          "routed_scaling_factor": ("moe", "routed_scale"),
          "alpha": ("moe", "router_aux_weight"),
          "gamma": ("moe", "bias_rate")}


def model_config(config):
    """The registered config with the file's cut."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FFConfig

    base = get_config(config["name"])
    for key, path in WIDTHS.items():
        v = base
        for p in path:
            v = getattr(v, p)
        if v != config[key]:
            raise ValueError(f"{key}: the file has {config[key]}, the "
                             f"program's {config['name']} {v}")
    L, dense = config["num_hidden_layers"], config["first_k_dense_replace"]
    return dataclasses.replace(
        base, num_layers=L, vocab=config["vocab_size"], dtype=config["dtype"],
        groups=((("mla_dense",), dense), (("mla_moe",), L - dense)),
        moe=dataclasses.replace(base.moe,
                                experts_held=config["n_routed_experts"],
                                expert_offset=config["expert_offset"]),
        ff=FFConfig(theta=config["theta"]))


def _mlp(w, j):
    if j == 0:
        return {"wi": w["wi"], "wg": w["wg"], "wo": w["wo_mlp"]}
    return {"router": w["router"], "bias": w["bias"], "wi": w["wi"],
            "wg": w["wg"], "wo": w["wo_mlp"],
            "shared": {"wi": w["shared_wi"], "wg": w["shared_wg"],
                       "wo": w["shared_wo"]}}


def _group(w, j):
    return ({"norm1": w["norm1"],
             "attn": {k: w[k] for k in ("wq", "wkva", "kv_norm", "wkvb",
                                        "wo")},
             "norm2": w["norm2"], "mlp": _mlp(w, j)},)


def program_tree(w):
    """The program's params layout over the benchmark's weights: the
    dense group, then the MoE group, leaves stacked."""
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "groups": (_group(w["dense"], 0), _group(w["moe"], 1)),
            "lm_head": w["lm_head"]}


def _leaves(g, j):
    """A group's stacked leaves under the benchmark's names."""
    b = g[0]
    out = {"norm1": b["norm1"], "norm2": b["norm2"], **b["attn"]}
    m = b["mlp"]
    out.update(wi=m["wi"], wg=m["wg"], wo_mlp=m["wo"])
    if j:
        out.update(router=m["router"], bias=m["bias"],
                   shared_wi=m["shared"]["wi"], shared_wg=m["shared"]["wg"],
                   shared_wo=m["shared"]["wo"])
    return out


def bench_layout(tree):
    """``program_tree``'s inverse (views)."""
    return {"embed": tree["embed"], "lm_head": tree["lm_head"],
            "final_norm": tree["final_norm"],
            "dense": _leaves(tree["groups"][0], 0),
            "moe": _leaves(tree["groups"][1], 1)}


def _unit(tree, j):
    return {f"{j}.{n}": t for n, t in wm.unit(bench_layout(tree), j).items()}


def _keep(t):
    """A host copy that later in-place updates cannot reach."""
    return t.detach().to("cpu", copy=True)


@contextlib.contextmanager
def routes_noted(out):
    """Each call of the program's sigmoid router appends its choices
    (T, k) to ``out`` (a host copy) while the context is open."""
    from repro_torch.models import mlp

    orig = mlp.sigmoid_router

    def noted(p, x, moe, seqs):
        res = orig(p, x, moe, seqs)
        out.append(_keep(res[1]))
        return res

    mlp.sigmoid_router = noted
    try:
        yield out
    finally:
        mlp.sigmoid_router = orig


def make_data(cell, seed):
    t, c = cell["traffic"], cell["config"]
    rows = t["batch"] * t["steps_per_chapter"] * (c["num_hidden_layers"] + 1)
    return traffic_lib.make({**t["data"], "vocab": c["vocab_size"],
                             "rows": rows, "seq": t["seq"]}, seed)


class Session:
    unit = "tokens"

    def __init__(self, cell, seed, device, spans):
        from repro_torch import optim
        from repro_torch.core import pff_lm
        from repro_torch.core.rng import TorchKey

        config, traffic = cell["config"], cell["traffic"]
        self.device, self.spans = device, spans
        self.cfg = model_config(config)
        self.L = config["num_hidden_layers"]
        self.batch, self.steps = traffic["batch"], traffic["steps_per_chapter"]
        t0 = time.perf_counter()
        self.data = make_data(cell, seed)
        self.pool = torch.as_tensor(self.data["tokens"], device=device)
        self.stages = {"inputs_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.params = program_tree(wm.make(config, seed, device))
        self.opt = optim.adam_init(self.params)
        lr = traffic["lr"]
        self.step = pff_lm.make_block_step(self.cfg, lr=lr, seed=seed,
                                           key_fn=TorchKey, impl="auto")
        self.head_step = pff_lm.make_head_step(self.cfg, head_lr=lr,
                                               impl="auto")
        self.tokens = self.batch * traffic["seq"] * self.steps
        self.n = self.n_head = 0
        self.chapter_no = 0
        self.readings = {"routes": [], "grad1": {}}
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

    def _record_block(self, k, loss):
        r = self.readings
        r.setdefault("loss", []).append(float(loss))
        for name, m in _unit(self.opt["m"], k).items():
            if not name.endswith(".bias"):
                r["grad1"][name] = _keep(m / (1 - lm_ref.B1))
        if self.n == PROVE:
            r["params"], r["bias"] = {}, {}
            for j in range(PROVE):
                for name, t in _unit(self.params, j).items():
                    (r["bias"] if name.endswith(".bias")
                     else r["params"])[name] = _keep(t)
            r["batches"] = [_keep(self._batch(0, j, 0)["tokens"])
                            for j in range(PROVE)]

    def _block_step(self, c, k, s, record):
        batch = self._batch(c, k, s)
        if not record:
            return self.step(self.params, self.opt, batch, k, self.n)
        with routes_noted(self.readings["routes"]):
            out = self.step(self.params, self.opt, batch, k, self.n)
        self._record_block(k, out[2])
        return out

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
                    self.params, self.opt, last = self._block_step(
                        c, k, s, record and self.n <= PROVE)
                self._sync()
                self.losses.append(float(last))
        if record:
            self.readings["head_state"] = {
                "embed": _keep(self.params["embed"]),
                "lm_head": _keep(self.params["lm_head"]),
                "final_norm": _keep(self.params["final_norm"]),
                **{g: {n: _keep(t) for n, t in leaves.items()}
                   for g, leaves in bench_layout(self.params).items()
                   if g in ("dense", "moe")}}
        routes = []
        with task_span(self.spans, "head"):
            for s in range(self.steps):
                self.n_head += 1
                hb = self._batch(c, self.L, s)
                with (routes_noted(routes) if record
                      else contextlib.nullcontext()):
                    self.params, self.opt, hloss = self.head_step(
                        self.params, self.opt, hb, self.n_head)
            self._sync()
        if record:
            m = self.opt["m"]
            self.readings["head"] = {
                "loss": [float(hloss)],
                "grad1": {n: _keep(m[n] / (1 - lm_ref.B1))
                          for n in ("final_norm", "lm_head")},
                "batch": _keep(hb["tokens"]), "routes": routes}
        self.chapter_no += 1
        return self.tokens

    def free(self):
        self.params = self.opt = self.pool = None


def follow(cell, seed, device, readings, data, *, precision="f32",
           half_batch=False):
    """The reference: the first three block steps from the seed's
    weights, and the head step from the program's state at its start,
    over the batches the program took, taking its routing choices."""
    cfg = {**cell["config"], "lr": cell["traffic"]["lr"]}
    w = wm.make(cell["config"], seed, device)
    batches = [b.to(device) for b in readings["batches"]]
    out = ref.follow_blocks(w, cfg, batches, seed, cfg["lr"],
                            readings["routes"], precision=precision,
                            half_batch=half_batch)
    out["start"] = {f"{j}.{n}": t for j in range(PROVE)
                    for n, t in wm.unit(w, j).items()}
    del w
    hs = readings["head_state"]
    state = {k: ({n: t.to(device) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in hs.items()}
    h = readings["head"]
    out["head"] = ref.head_step(state, cfg, h["batch"].to(device),
                                h["routes"], precision=precision,
                                half_batch=half_batch)
    return out


def numbers(readings, reference):
    """The cell's numbers: the three block steps' loss gap; blocks 0-2's
    first gradients and their change after step 3 by the worst leaf; the
    routers' biases after step 3 (largest difference); the head step's
    loss gap and its gradient by the worst leaf; and the share of the
    program's routing choices that the reference's own top k would not
    make (a control's own share, where it is put in the program's
    place)."""
    keep_g = compare.moved(reference["grad1"])
    grad = compare.worst_leaf_gap(readings["grad1"], reference["grad1"],
                                  keep_g)
    start = reference["start"]
    chg = compare.worst_leaf_gap(
        compare.change(readings["params"], start),
        compare.change(reference["params"], start), keep_g)
    bias = max(float((readings["bias"][n].to(t.device) - t).abs().max())
               for n, t in reference["bias"].items())
    h, rh = readings["head"], reference["head"]
    side = readings if "agree" in readings else reference
    side_h = h if "agree" in h else rh
    agree = (side["agree"] + side_h["agree"]) / (side["n"] + side_h["n"])
    return {"loss_gap": compare.loss_gap(readings["loss"], reference["loss"]),
            "grad_gap": grad, "change_gap": chg, "bias_gap": bias,
            "head_loss_gap": compare.loss_gap(h["loss"], rh["loss"]),
            "head_grad_gap": compare.worst_leaf_gap(h["grad1"], rh["grad1"]),
            "route_disagreement": 1.0 - agree}


CONTROLS = {"fp8": {"precision": "fp8"}, "half_batch": {"half_batch": True}}


def control_readings(cell, seed, device, readings, data, mode):
    """The reference put in the program's place, as the program's
    readings: ``fp8`` (the control) or ``half_batch`` (a planted
    fault)."""
    out = follow(cell, seed, device, readings, data, **CONTROLS[mode])
    return {"loss": out["loss"], "grad1": out["grad1"],
            "params": out["params"], "bias": out["bias"],
            "agree": out["agree"], "n": out["n"], "head": out["head"]}


def check(cell, seed, device, readings, data):
    """The cell's numbers for the program's readings."""
    return numbers(readings, follow(cell, seed, device, readings, data))
