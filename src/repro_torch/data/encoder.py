"""Self-contained byte-level BPE tokenizer (GPT-2-style merges): the
port's own copy of ``repro.data.encoder``, with its own copy of the
corpus sample beside it; merges and ids are bit-identical to the
reference's (tested).

The vocabulary starts from the 256 possible bytes, so ANY string
encodes and ``decode(encode(s)) == s`` exactly — the identity property
the deterministic data pipeline is built on (``data.TextSource``).
Merges are learned greedily on the checked-in corpus sample
(``corpus_sample.txt``): each round merges the most frequent adjacent
pair into a new token, ties broken by lowest pair ids, so training is
a pure function of ``(text, vocab_size)`` — every node reconstructs
the identical tokenizer with zero communication, the same contract
``data.Source`` promises for batches.

Text is pre-split into word-ish chunks (letters / digits / punctuation
runs, each with an optional leading space, GPT-2-style) so merges never
cross a word boundary; the split is a partition of the input, which is
what guarantees the round-trip. No external deps, no downloaded merge
table — the container is offline.
"""
from __future__ import annotations

import functools
import os
import re
from collections import Counter
from typing import Dict, List, Tuple

# Partition (not just match) of any string: every char is whitespace,
# a letter, a digit, or other; a single leading space attaches to the
# following chunk (GPT-2's " word" convention) and `\s+(?!\S)` stops a
# whitespace run one short of a following chunk so that space is left
# for it.
_SPLIT = re.compile(
    r" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")

_CORPUS_PATH = os.path.join(os.path.dirname(__file__),
                            "corpus_sample.txt")


def corpus_text() -> str:
    """The checked-in corpus sample (training text for the default
    encoder AND the default ``data.TextSource`` token stream)."""
    with open(_CORPUS_PATH, encoding="utf-8") as f:
        return f.read()


def _merge(ids: List[int], pair: Tuple[int, int], new_id: int
           ) -> List[int]:
    """One pass replacing every occurrence of ``pair`` with ``new_id``."""
    out = []
    i = 0
    while i < len(ids):
        if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


class Encoder:
    """Byte-level BPE encoder/decoder over an ordered merge list.

    ``merges[i]`` is the pair merged into token ``256 + i``; rank order
    IS priority order at encode time (lowest rank merges first), exactly
    the greedy scheme the trainer used — so encoding the training text
    reproduces the trainer's final symbol stream.
    """

    def __init__(self, merges: List[Tuple[int, int]]):
        self.merges: Dict[Tuple[int, int], int] = {
            pair: 256 + i for i, pair in enumerate(merges)}
        self._bytes: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._cache: Dict[str, Tuple[int, ...]] = {}

    @property
    def n_vocab(self) -> int:
        return len(self._bytes)

    def _encode_chunk(self, chunk: str) -> Tuple[int, ...]:
        ids = list(chunk.encode("utf-8"))
        while len(ids) >= 2:
            # lowest-rank pair present merges next (ties impossible:
            # ranks are unique)
            pair = min(zip(ids, ids[1:]),
                       key=lambda p: self.merges.get(p, 1 << 30))
            if pair not in self.merges:
                break
            ids = _merge(ids, pair, self.merges[pair])
        return tuple(ids)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for chunk in _SPLIT.findall(text):
            ids = self._cache.get(chunk)
            if ids is None:
                ids = self._encode_chunk(chunk)
                self._cache[chunk] = ids
            out.extend(ids)
        return out

    def decode(self, ids) -> str:
        return b"".join(self._bytes[int(i)] for i in ids).decode(
            "utf-8", errors="replace")


def train_bpe(text: str, vocab_size: int) -> Encoder:
    """Greedy BPE on ``text`` up to ``vocab_size`` tokens (>= 256).

    Deterministic: pair counts are exact, the winner is
    ``max((count, -a, -b))`` so ties resolve to the lowest pair ids
    regardless of dict iteration order. Stops early if no pair repeats.
    """
    if vocab_size < 256:
        raise ValueError(f"byte-level BPE needs vocab_size >= 256, "
                         f"got {vocab_size}")
    words = Counter(_SPLIT.findall(text))
    seqs = {w: list(w.encode("utf-8")) for w in words}
    merges: List[Tuple[int, int]] = []
    for new_id in range(256, vocab_size):
        counts: Counter = Counter()
        for w, n in words.items():
            s = seqs[w]
            for pair in zip(s, s[1:]):
                counts[pair] += n
        if not counts:
            break
        best = max(counts, key=lambda p: (counts[p], -p[0], -p[1]))
        if counts[best] < 2:
            break
        merges.append(best)
        for w in seqs:
            if best[0] in seqs[w]:
                seqs[w] = _merge(seqs[w], best, new_id)
    return Encoder(merges)


@functools.lru_cache(maxsize=None)
def default_encoder(vocab_size: int = 512) -> Encoder:
    """The repo's default tokenizer: BPE trained on the checked-in
    corpus sample (memoized per vocab size)."""
    return train_bpe(corpus_text(), vocab_size)
