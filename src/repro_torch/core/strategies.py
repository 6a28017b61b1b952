"""Strategy registries of the port (``repro.core.strategies``'s
counterparts).

The paper's variation axes are registries of looked-up callables: WHAT
each layer trains (``goodness``: sum-of-squares vs the Performance-
Optimized local-head loss, §4.4) and WHICH classifier produces label
scores (``classifier``). The builtins are registered at the bottom of
``core.ff_mlp``. The ``negatives`` registry and its builtins come with
the training slice; ``NegativesStrategy`` is here so the three strategy
types keep one home.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


class Registry:
    """A tiny name -> strategy map with helpful lookup errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries = {}

    def register(self, name: str, entry, *, overwrite: bool = False):
        if not overwrite and name in self._entries:
            raise ValueError(
                f"{self.kind} strategy {name!r} already registered "
                "(pass overwrite=True to replace)")
        self._entries[name] = entry
        return entry

    def unregister(self, name: str):
        """Remove a strategy (no-op if absent)."""
        self._entries.pop(name, None)

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} strategy {name!r}; registered: "
                f"{', '.join(self.names())}") from None

    def names(self):
        return tuple(sorted(self._entries))

    def __contains__(self, name):
        return name in self._entries

    def __iter__(self):
        return iter(self.names())


@dataclasses.dataclass(frozen=True)
class NegativesStrategy:
    """How negative samples are (re)generated:
    ``fn(generator, cfg, params, x, y, scores) -> (N, D)`` label-overlaid
    images. ``regenerates``: a per-chapter regeneration task exists;
    ``needs_scores``: regeneration reads the live model's class scores."""
    name: str
    fn: Callable
    regenerates: bool = True
    needs_scores: bool = False


@dataclasses.dataclass(frozen=True)
class GoodnessStrategy:
    """What each layer trains during its chapter task.

      get_state(params, opt, k)          -> state (first element: the
                                            layer's param dict)
      set_state(params, opt, k, state)   writes state back
      train_chapter(state, acts, extras, lrs, generator, *, cfg, epochs)
                                         -> state
      export(states)                     -> partial params dict

    uses_negatives: False means labeled data only (the §4.4 path).
    eval_mode(cfg): the classifier-registry entry used for evaluation.
    init_extras(generator, cfg), when set, returns extra parameter
    groups (e.g. the §4.4 local heads) merged into ``ff_mlp.init``'s
    params.
    """
    name: str
    uses_negatives: bool
    get_state: Callable
    set_state: Callable
    train_chapter: Callable
    export: Callable
    eval_mode: Callable
    init_extras: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class ClassifierStrategy:
    """How (B, C) label scores are produced at prediction time:
    ``scores(params, x, *, num_classes, impl) -> (B, C)``, higher = more
    predicted. ``trains_head`` marks classifiers that need the softmax
    head; ``requires_goodness`` names the goodness strategy whose
    parameters the classifier reads."""
    name: str
    scores: Callable
    trains_head: bool = False
    requires_goodness: Optional[str] = None


goodness = Registry("goodness")
classifier = Registry("classifier")


def register_goodness(name, strategy, *, overwrite=False):
    return goodness.register(name, strategy, overwrite=overwrite)


def register_classifier(name, scores, *, trains_head=False,
                        requires_goodness=None, overwrite=False):
    return classifier.register(
        name, ClassifierStrategy(name, scores, trains_head,
                                 requires_goodness),
        overwrite=overwrite)
