"""Strategy registries of the port (``repro.core.strategies``'s
counterparts).

The paper's variation axes are registries of looked-up callables: HOW
negatives are generated (``negatives``: AdaptiveNEG / FixedNEG /
RandomNEG, registered here), WHAT each layer trains (``goodness``:
sum-of-squares vs the Performance-Optimized local-head loss, §4.4) and
WHICH classifier produces label scores (``classifier``). The goodness
and classifier builtins are registered at the bottom of
``core.ff_mlp``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import ff


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
    ``fn(key, cfg, params, x, y, scores) -> (N, D)`` label-overlaid
    images (raw; callers normalize). ``params`` and ``scores`` (the
    (N, C) class scores) are the live model only when ``needs_scores``,
    and None before a model exists (chapter 0), when every strategy
    degrades to key-only wrong labels. ``regenerates``: a per-chapter
    regeneration task exists; ``needs_scores``: regeneration reads the
    live model's class scores."""
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
      train_chapter(state, acts, extras, lrs, key, *, cfg, epochs)
                                         -> state (updated in place)
      export(states)                     -> partial params dict

    uses_negatives: False means labeled data only (the §4.4 path).
    eval_mode(cfg): the classifier-registry entry used for evaluation.
    init_extras(src, cfg), when set, returns extra parameter
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


negatives = Registry("negatives")
goodness = Registry("goodness")
classifier = Registry("classifier")


def register_negatives(name, fn, *, regenerates=True, needs_scores=False,
                       overwrite=False):
    """Plug a new negative-sample strategy into the facade."""
    return negatives.register(
        name, NegativesStrategy(name, fn, regenerates, needs_scores),
        overwrite=overwrite)


def register_goodness(name, strategy, *, overwrite=False):
    return goodness.register(name, strategy, overwrite=overwrite)


def register_classifier(name, scores, *, trains_head=False,
                        requires_goodness=None, overwrite=False):
    return classifier.register(
        name, ClassifierStrategy(name, scores, trains_head,
                                 requires_goodness),
        overwrite=overwrite)


# ---------------------------------------------------------------------------
# Builtin negative-sample strategies (paper §4.2)
# ---------------------------------------------------------------------------

def _random_negatives(key, cfg, params, x, y, scores):
    """RandomNEG: uniform over the C-1 wrong labels, fresh each chapter."""
    labels = ff.random_wrong_labels(key, y, cfg.num_classes)
    return ff.overlay_label(x, labels, cfg.num_classes)


def _adaptive_negatives(key, cfg, params, x, y, scores):
    """AdaptiveNEG: confusable wrong labels from the model's own class
    scores; RandomNEG before a model exists (chapter 0)."""
    if scores is None:
        return _random_negatives(key, cfg, params, x, y, scores)
    labels = ff.adaptive_wrong_labels(scores, y, key=key)
    return ff.overlay_label(x, labels, cfg.num_classes)


register_negatives("random", _random_negatives)
register_negatives("adaptive", _adaptive_negatives, needs_scores=True)
# FixedNEG = RandomNEG sampled once, never refreshed
register_negatives("fixed", _random_negatives, regenerates=False)
