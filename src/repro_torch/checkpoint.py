"""Checkpointing: trees of tensors <-> .npz with path-string keys (the
port's counterpart of ``repro.checkpoint``, in the same file format).

A tree is nested dicts, lists and tuples of tensors (or numpy arrays).
Each leaf is stored under the "/"-joined path to it, the keys of the
reference's ``jax.tree_util`` paths: a dict entry is its key, a list or
tuple entry its index, dict keys walked in sorted order, ``None`` is an
empty subtree. So the two packages read each other's files: the
reference restores what ``save`` writes here, and ``restore`` here reads
what the reference writes. bf16 leaves are stored upcast to f32, as the
reference stores them (``np.savez`` has no bf16).

Restore requires a template tree (for structure, dtypes and devices):
each restored tensor lands on its template leaf's device and dtype.

Writes are atomic (tmp file + ``os.replace``), so a reader never sees a
half-written archive: the property the PFF executor's chapter manifests
(``repro_torch.core.pff_exec``) rely on to survive a hard kill between
chapters. Those manifests also use the two extension points here:
``meta=`` (a JSON-serializable dict riding inside the archive, e.g. the
completed chapter + schedule fingerprint) and ``strict=`` restore (error
on archive keys the template did not consume).

Both entry points take ``tracer=`` (an ``obs.trace`` tracer; default the
no-op singleton): a traced save/restore records one ``checkpoint:save`` /
``checkpoint:restore`` span covering the device->host drain and the
serialization.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

# reserved archive keys (not tree leaves)
_STEP_KEY = "__step__"
_META_KEY = "__meta__"


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    sequence entries by index, ``None`` holding no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path):
    return "/".join(str(p) for p in path)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()              # np.savez can't persist bf16
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree):
    return {_key(path): _to_numpy(leaf)
            for path, leaf in _leaves_with_paths(tree)}


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in
    ``_leaves_with_paths`` order, from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: None for k in tree}          # keep the caller's key order
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], leaves)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def save(path, tree, step=None, meta=None, tracer=obs_trace.NOOP):
    """Atomically persist ``tree``; optionally a ``step`` int and a
    JSON-serializable ``meta`` dict (read back via ``restore(...,
    with_meta=True)``). Leaves on the card are copied to the host here,
    on the current stream."""
    t0 = tracer.now()
    flat = _flatten(tree)
    if _STEP_KEY in flat or _META_KEY in flat:
        raise ValueError(f"tree uses reserved key {_STEP_KEY}/{_META_KEY}")
    if step is not None:
        flat[_STEP_KEY] = np.asarray(step)
    if meta is not None:
        # json.dumps raises on non-serializable meta: fail at save time,
        # not at restore time
        flat[_META_KEY] = np.asarray(json.dumps(meta))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if tracer.enabled:
        tracer.add_span("checkpoint:save", t0,
                        path=os.path.basename(path), step=step,
                        bytes=os.path.getsize(path))


def restore(path, template, *, strict=False, with_meta=False,
            tracer=obs_trace.NOOP):
    """Returns ``(tree_like_template, step or None)``, or ``(tree, step,
    meta or None)`` with ``with_meta=True``. Each leaf is a tensor on its
    template leaf's device, in its dtype.

    strict=True: raise if the archive holds keys the template did not
    consume (the default ignores extras, fine for partial restores,
    wrong for manifests).
    """
    t0 = tracer.now()
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    step = data.pop(_STEP_KEY, None)
    meta = data.pop(_META_KEY, None)
    meta = json.loads(meta.item()) if meta is not None else None
    out = []
    consumed = set()
    for path_, leaf in _leaves_with_paths(template):
        key = _key(path_)
        if key not in data:
            raise KeyError(f"checkpoint missing {key}")
        consumed.add(key)
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(torch.from_numpy(np.array(arr)).to(
            device=leaf.device, dtype=leaf.dtype))
    if strict:
        extra = sorted(set(data) - consumed)
        if extra:
            raise ValueError(
                f"checkpoint holds {len(extra)} key(s) the template did "
                f"not consume: {', '.join(extra[:5])}"
                + ("..." if len(extra) > 5 else ""))
    tree = _rebuild(template, iter(out))
    step = int(step) if step is not None else None
    if tracer.enabled:
        tracer.add_span("checkpoint:restore", t0,
                        path=os.path.basename(path), step=step)
    return (tree, step, meta) if with_meta else (tree, step)
