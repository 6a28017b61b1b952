"""The reference's LM steps under a ``Dist``, for
``tests/test_torch_dist_train.py``, in a process of its own: the 4 host
devices it needs must be set before JAX starts.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:tests python -m jax_dist_ref OUTDIR CASE...

reads ``OUTDIR/dist_inputs.pkl`` (the test's inputs: numpy params, token
batches), runs under ``jax.jit`` on a (data 2, model 2) mesh, with the
params placed by the reference's ``param_specs``,
``make_ff_train_step`` (random negatives at S 16 and 80, AdaptiveNEG at
S 16) and ``make_bp_train_step`` of the reduced deepseek-moe-16b
(``Dist(batch ("data",), model "model", fsdp "data")``)
and ``make_ff_train_step`` of the reduced qwen2-0.5b with the model axis
folded into the batch axes, each one step from the given params, and
records ``launch.dryrun.make_dist``'s fields for every config on that
mesh and on a (pod 1, data 2, model 2) one: the CASEs ``ff16``,
``ff80``, ``ada16``, ``bp``, ``fold`` and ``make_dist``, side by side.
A CASE ``tp:NAME`` runs the tensor-parallel case NAME of the inputs
(``inputs["tp"][NAME]``: a reduced config with fields replaced, its
batch and prompts): it draws the case's params with the reference's own
``init`` (cross-attention gates set to 1, since init's 0 hides the cross
path) and writes them to ``OUTDIR/tp_params_<NAME>.pkl`` for the ranks
first, then runs under ``make_dist`` one FF step, one backprop step
where the case asks for it, and prefill then greedy decode steps
(``prefill``, ``serve_step``), each token the argmax of the last
logits, keeping the caches after the last step. A CASE ``b1:NAME``
serves the batch-1 case NAME (``inputs["b1"][NAME]``) the same way,
its params written to ``OUTDIR/tp_params_b1-<NAME>.pkl``.
Writes each case's new params and metrics (or the fields, or the
logits and tokens) to ``OUTDIR/ref_<CASE>.pkl``.

The mesh is built with ``jax.sharding.Mesh``: ``jax.make_mesh`` gives
Explicit axes on this jax, under which ``Dist.constrain_batch`` raises.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np


def main(outdir, cases):
    # the backend starts here, with XLA_FLAGS's 4 devices: launch.dryrun
    # sets another device count when it is imported
    devs = np.array(jax.devices())
    from repro import optim, sharding
    from repro.configs import get_config, list_configs
    from repro.core import train
    from repro.launch import dryrun
    from repro.models import transformer
    from repro.models.mlp import Dist

    with open(os.path.join(outdir, "dist_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = jax.sharding.Mesh(devs.reshape(2, 2), ("data", "model"))
    pod = jax.sharding.Mesh(devs.reshape(1, 2, 2), ("pod", "data", "model"))

    def make_dists():
        return {(name, label, fold): (tuple(d.batch_axes), d.model_axis,
                                      d.fsdp_axis)
                for name in list_configs()
                for label, m in (("2x2", mesh), ("pod", pod))
                for fold in (False, True)
                for d in [dryrun.make_dist(get_config(name), m,
                                           batch_fold_model=fold)]}

    def placed(npp):
        params = jax.tree_util.tree_map(jnp.asarray, npp)
        return jax.device_put(params, sharding.shardings(
            sharding.param_specs(params, mesh), mesh))

    def run(cfg, make, dist, npp, tokens, aux=None):
        params = placed(npp)
        step = jax.jit(make(cfg, dist=dist, lr=1e-3))
        batch = {"tokens": jnp.asarray(tokens)}
        if aux is not None:
            batch["aux"] = jnp.asarray(aux)
        with mesh:
            new, _, metrics = step(params, optim.adam_init(params), batch,
                                   jnp.int32(1))
        return (jax.tree_util.tree_map(np.asarray, new),
                {k: float(v) for k, v in metrics.items()})

    def serve(cfg, dist, npp, prompts, gen, aux=None):
        params = placed(npp)
        P = prompts.shape[1]
        pre = jax.jit(lambda p, t, a: transformer.prefill(
            p, cfg, t, aux=a, dist=dist, max_len=P + gen))
        dec = jax.jit(lambda p, c, t, pos: transformer.serve_step(
            p, cfg, c, t, pos, dist=dist))
        a = None if aux is None else jnp.asarray(aux)
        with mesh:
            logits, caches = pre(params, jnp.asarray(prompts), a)
            out, toks = [np.asarray(logits)], []
            for i in range(gen):
                tok = jnp.argmax(logits[:, -1] if logits.ndim == 3
                                 else logits, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
                logits, caches = dec(params, caches, tok, jnp.int32(P + i))
                out.append(np.asarray(logits))
        return {"logits": out, "tokens": toks,
                "caches": jax.tree_util.tree_map(np.asarray, caches)}

    def tp_params(name, cfg):
        params = jax.tree_util.tree_map(
            np.asarray, transformer.init(jax.random.PRNGKey(0), cfg))
        for g in params["groups"]:
            for blk in g:
                if "gate" in blk.get("attn", {}):
                    blk["attn"]["gate"] = np.ones_like(blk["attn"]["gate"])
        path = os.path.join(outdir, f"tp_params_{name}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(params, f)
        os.replace(path + ".part", path)
        return params

    def tp_case(name):
        case = inputs["tp"][name]
        cfg = dataclasses.replace(get_config(case["base"]).reduced(),
                                  **dict(case["fields"]))
        d = dryrun.make_dist(cfg, mesh)
        params = tp_params(name, cfg)
        out = {"ff": run(cfg, train.make_ff_train_step, d, params,
                         case["tokens"], case.get("aux")),
               "serve": serve(cfg, d, params, case["prompts"], case["gen"],
                              case.get("aux"))}
        if case["bp"]:
            out["bp"] = run(cfg, train.make_bp_train_step, d, params,
                            case["tokens"], case.get("aux"))
        return out

    def b1_case(name):
        case = inputs["b1"][name]
        cfg = dataclasses.replace(get_config(case["base"]).reduced(),
                                  **dict(case["fields"]))
        params = tp_params(f"b1-{name}", cfg)
        return {"serve": serve(cfg, dryrun.make_dist(cfg, mesh), params,
                               case["prompts"], case["gen"])}

    moe = get_config("deepseek-moe-16b").reduced()
    ada = dataclasses.replace(moe, ff=dataclasses.replace(
        moe.ff, neg_mode="adaptive"))
    dense = get_config("qwen2-0.5b").reduced()
    ep = Dist(mesh=mesh, batch_axes=("data",), model_axis="model",
              fsdp_axis="data")
    fold = dryrun.make_dist(dense, mesh, batch_fold_model=True)
    ds, qw = inputs["deepseek"], inputs["qwen2"]
    steps = {"ff16": (moe, train.make_ff_train_step, ep, ds["ff16"]),
             "ff80": (moe, train.make_ff_train_step, ep, ds["ff80"]),
             "bp": (moe, train.make_bp_train_step, ep, ds["bp"]),
             "ada16": (ada, train.make_ff_train_step, ep, ds["ada16"]),
             "fold": (dense, train.make_ff_train_step, fold, qw["ff"])}
    # one thread a case: XLA compiles them side by side
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futs = {case: pool.submit(make_dists) if case == "make_dist" else
                pool.submit(tp_case, case[3:]) if case.startswith("tp:") else
                pool.submit(b1_case, case[3:]) if case.startswith("b1:") else
                pool.submit(run, *steps[case][:3],
                            (qw if case == "fold" else ds)["params"],
                            steps[case][3])
                for case in cases}
        out = {case: f.result() for case, f in futs.items()}
    for case, res in out.items():
        with open(os.path.join(outdir, f"ref_{case}.pkl"), "wb") as f:
            pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
