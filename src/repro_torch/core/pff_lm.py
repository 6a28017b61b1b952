"""The paper's chapter schedule applied to transformer stacks (the port of
``repro.core.pff_lm``).

``core.train.make_ff_train_step`` trains every block each step ("joint
FF"). This module runs the paper's actual schedule instead: chapters of
per-BLOCK training (chapter c trains block k for a fixed step budget on
the outputs of blocks < k), producing the same ``TaskRecord`` stream the
PFF simulator consumes, and a per-chapter softmax-head task.

Routing (``core.train``'s rule): the trained block's forward runs
through the plain attention / SSD under autograd (``impl="ref"``); the
frozen prefix of blocks < k and the head task's forward through every
block need no gradient and run under ``torch.no_grad()`` with the step
maker's ``impl`` (default "auto": the CUDA kernels on the card).

Two levels, so that the executor (``pff_exec.LMExecutor``) replays
exactly the sequential trainer's calls without assembling full trees:
``make_block_task`` / ``make_head_task`` take the pieces a task reads
(the embedding table, the prefix blocks' unit trees, the trained state),
and ``make_block_step`` / ``make_head_step`` wrap them with the
reference's signatures over full params / Adam trees, whose blocks are
views of the stacked leaves. Params and Adam state are updated in place.
"""
from __future__ import annotations

import time
from typing import List

import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import ff
from repro_torch.core import train as train_lib
from repro_torch.core.pff import TaskRecord
from repro_torch.core.rng import TorchKey
from repro_torch.device import resolve_device
from repro_torch.models import blocks, transformer


def check_chapter_config(cfg):
    """The chapter schedule trains blocks on token embeddings alone. An
    encoder-decoder config, or one with cross-attention blocks (a vision
    config), reads stub frontend embeddings that the schedule does not
    take, as the reference's does not (``repro/core/pff_lm.py:46`` builds
    one group, and its ctx at :61 has no "aux"): such a config is
    refused, and trains by the joint step instead."""
    kinds = {k for pattern, _ in cfg.groups for k in pattern}
    if cfg.enc_dec or kinds & {"cross_attn", "xdec"}:
        raise ValueError(
            f"the chapter schedule takes no stub frontend embeddings (aux), "
            f"which {cfg.name!r} reads (an encoder, or cross-attention "
            f"blocks), and the reference's chapter schedule cannot train it "
            f"either: train it with the joint step, core.train."
            f"make_ff_train_step / make_bp_train_step with batch['aux'], or "
            f"`python -m repro_torch.launch.train --arch {cfg.name}` "
            f"without --chapters")


def _pattern(cfg):
    check_chapter_config(cfg)
    if len(cfg.groups) != 1:
        raise ValueError("the chapter schedule needs a uniform stack (one "
                         f"group); got {len(cfg.groups)}")
    return cfg.groups[0]


def block_units(params, n):
    """Units 0..n-1 of the (one) group of ``params``: views."""
    return [train_lib.unit_views(params["groups"][0], j) for j in range(n)]


def frozen_forward(cfg, embed, units, tokens, impl):
    """No-grad forward of ``tokens`` through the embedding and ``units``
    (each a tuple of the pattern's block trees), with ``impl``."""
    pattern = cfg.groups[0][0]
    ctx = {"causal": True, "impl": impl}
    with torch.no_grad():
        x = F.embedding(tokens.long(), embed)
        for unit in units:
            for kind, bp in zip(pattern, unit):
                x, _ = blocks.block_apply(bp, cfg, kind, x, ctx)
    return x


def make_block_task(cfg, *, lr=1e-3, seed=0, theta=None, key_fn=TorchKey,
                    impl="auto"):
    """Returns task_step(embed, prefix, state, batch, block_idx, step_no)
    -> loss: one grad step of block ``block_idx`` on the outputs of the
    ``prefix`` units (blocks < block_idx); ``state`` is the block's
    ``(unit params, unit m, unit v)``, updated in place."""
    pattern, repeat = _pattern(cfg)
    theta = theta if theta is not None else cfg.ff.theta

    def task_step(embed, prefix, state, batch, block_idx, step_no):
        if not 0 <= block_idx < repeat:
            raise ValueError(f"block {block_idx} of {repeat}")
        tokens = batch["tokens"][:, :-1]
        B = tokens.shape[0]
        dev = tokens.device
        key = key_fn(seed).fold_in(step_no)
        neg = ff.corrupt_tokens(key, tokens, cfg.vocab)
        x = frozen_forward(cfg, embed, prefix,
                           torch.cat([tokens, neg], dim=0), impl)
        is_pos = torch.cat([torch.ones((B,), device=dev),
                            torch.zeros((B,), device=dev)])
        up, um, uv = state
        tp = train_lib.trainable(up)
        with torch.enable_grad():
            h = x
            total = torch.zeros((), device=dev)
            for kind, bp in zip(pattern, tp):
                h_sg = h.detach()
                y, moe_aux = blocks.block_apply(bp, cfg, kind, h_sg,
                                                train_lib.REF)
                g = ff.mean_goodness(y - h_sg)
                total = total + ff.ff_loss_masked(g, is_pos, theta) \
                    + 0.01 * moe_aux
                h = y
            grads = train_lib.grads_of(total, tp)
        train_lib.adam_leaves(up, grads, um, uv, lr=lr, step=step_no)
        return total.detach()

    return task_step


def make_block_step(cfg, *, lr=1e-3, seed=0, theta=None, key_fn=TorchKey,
                    impl="auto"):
    """Returns step(params, opt, batch, block_idx, step_no) ->
    (params, opt, loss) that updates ONLY block ``block_idx`` (the
    paper's per-node task), in place. Single-group architectures."""
    task = make_block_task(cfg, lr=lr, seed=seed, theta=theta,
                           key_fn=key_fn, impl=impl)

    def step(params, opt_state, batch, block_idx, step_no):
        k = block_idx
        units = block_units(params, k + 1)
        state = (units[k],
                 train_lib.unit_views(opt_state["m"]["groups"][0], k),
                 train_lib.unit_views(opt_state["v"]["groups"][0], k))
        loss = task(params["embed"], units[:k], state, batch, k, step_no)
        return params, opt_state, loss

    return step


def head_param_names(cfg):
    """The per-chapter head task's parameter subset: ``final_norm`` plus
    the softmax weights, the tied embedding table (which then doubles as
    the paper's softmax layer) or the untied ``lm_head``."""
    return ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")


def make_head_task(cfg, *, head_lr=1e-3, impl="auto"):
    """Returns task_step(embed, units, head, batch, step_no) -> loss: a
    frozen forward through ALL ``units``, then local CE on the head
    subset; ``head`` is ``(params, m, v)`` dicts over
    ``head_param_names``, updated in place. ``embed`` is the table the
    forward reads (the head's own when tied)."""
    _pattern(cfg)
    names = head_param_names(cfg)

    def task_step(embed, units, head, batch, step_no):
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        x = frozen_forward(cfg, embed, units, inp, impl)
        hp, hm, hv = head
        tp = train_lib.trainable({k: hp[k] for k in names})
        with torch.enable_grad():
            loss = train_lib.head_ce(x, tp, cfg, labels)
            grads = train_lib.grads_of(loss, tp)
        train_lib.adam_leaves({k: hp[k] for k in names}, grads,
                              {k: hm[k] for k in names},
                              {k: hv[k] for k in names},
                              lr=head_lr, step=step_no)
        return loss.detach()

    return task_step


def make_head_step(cfg, *, head_lr=1e-3, impl="auto"):
    """Returns head_step(params, opt, batch, step_no) -> (params, opt,
    loss): the per-chapter softmax-head task (DAG ``Task("head",
    n_layers, c)``), in place. Features are detached, so a tied table
    receives the CE grad only through the unembed."""
    _, repeat = _pattern(cfg)
    task = make_head_task(cfg, head_lr=head_lr, impl=impl)

    def head_step(params, opt_state, batch, step_no):
        loss = task(params["embed"], block_units(params, repeat),
                    (params, opt_state["m"], opt_state["v"]), batch,
                    step_no)
        return params, opt_state, loss

    return head_step


def chapter_batches(source, *, batch, steps, device=None):
    """The canonical (chapter, task)-addressed batch stream over a
    ``data.TextSource``-style source: a pure function of its arguments,
    so the sequential trainer and every executor node regenerate
    identical batches locally. The head task is addressed as
    ``block = n_blocks``. Batches land on ``device`` (default ``cuda``)
    on the current stream."""
    dev = resolve_device(device)

    def data_iter(chapter, block):
        blk = source.blocks("train", batch * steps,
                            seed=chapter * 1009 + block)
        for s in range(steps):
            yield {"tokens": torch.as_tensor(
                blk[s * batch:(s + 1) * batch], device=dev)}
    return data_iter


def init_params(cfg, seed, device=None):
    """The chapter trainers' initial params: ``transformer.init`` from a
    ``torch.Generator`` seeded by ``seed`` on ``device``."""
    dev = resolve_device(device)
    return transformer.init(torch.Generator(device=dev).manual_seed(seed),
                            cfg)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def train_chapters(cfg, data_iter_fn, *, chapters, steps_per_chapter,
                   lr=1e-3, head_lr=None, seed=0, params=None,
                   key_fn=TorchKey, impl="auto", device=None):
    """Runs the chapter schedule; returns (params, records, ff_losses).

    data_iter_fn(chapter, block) -> iterable of batches for that task;
    the per-chapter head task draws ``data_iter_fn(c, n_blocks)``. The
    head (final_norm + lm_head / embed-as-softmax) trains at the end of
    each chapter at ``head_lr`` (default ``lr``); its ``TaskRecord("head",
    n_blocks, c)`` rides the record stream the simulator consumes.
    ``ff_losses`` holds one FF loss per block task.

    params: the initial params (copied, so the caller's tree is left as
    it was); default ``init_params(cfg, seed, device)``. key_fn: the
    negatives' keys (``key_fn(seed).fold_in(step)``). impl: the route of
    the no-grad forwards. Task records are host times around work that
    ends in a synchronize.
    """
    _, repeat = _pattern(cfg)
    if params is None:
        params = init_params(cfg, seed, device)
    else:
        params = tree_map(lambda t: t.clone(), params)
    dev = tree_leaves(params)[0].device
    opt = optim.adam_init(params)
    step = make_block_step(cfg, lr=lr, seed=seed, key_fn=key_fn, impl=impl)
    head_step = make_head_step(
        cfg, head_lr=lr if head_lr is None else head_lr, impl=impl)
    records: List[TaskRecord] = []
    losses = []
    n = 0
    n_head = 0
    for c in range(chapters):
        for k in range(repeat):
            t0 = time.perf_counter()
            last = None
            for batch in data_iter_fn(c, k):
                n += 1
                params, opt, last = step(params, opt, batch, k, n)
            _sync(dev)
            records.append(TaskRecord("train", k, c,
                                      time.perf_counter() - t0))
            losses.append(float(last))
        t0 = time.perf_counter()
        for batch in data_iter_fn(c, repeat):
            n_head += 1
            params, opt, _ = head_step(params, opt, batch, n_head)
        _sync(dev)
        records.append(TaskRecord("head", repeat, c,
                                  time.perf_counter() - t0))
    return params, records, losses


def lm_params_bit_equal(a, b) -> bool:
    """True iff two transformer params trees are BIT-identical on every
    leaf (same structure, dtypes and bits): the LM executor's oracle."""
    la, lb = tree_leaves(a), tree_leaves(b)
    same_shape = (tree_map(lambda _: 0, a) == tree_map(lambda _: 0, b)
                  and len(la) == len(lb))
    return same_shape and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))
