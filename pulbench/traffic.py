"""The one traffic generator: reads a mix's parameters (``traffic/*.json``)
and draws its requests from ``--seed``.

Every seed sends the same sizes in the same order; the seed draws the
token ids (uniform in [1, vocab)), as it draws the weights. (Where the seed
also permuted the sizes, the order of long and short prompts across the
slots changed the work: two seeds' tokens a second differed by up to 16 %,
two runs of one seed by 3.5 %.)

* the sizes are the quantiles (i + 1/2) / n of the mix's distribution
  (``loguniform`` over [lo, hi]; ``lognormal`` with a median and sigma,
  clipped to [lo, hi]), rounded, in one fixed shuffled order;
* ``closed_batch`` (``sessions`` requests, all submitted in set-up): each
  session asks for ``"output": {"tokens": n}`` tokens, more than any
  window can serve, so none ends in it; ``engine.hot_pages`` may size the pool to what the
  sessions can fill (``session_pages``);
* ``closed_loop`` (``clients`` callers with no think time, each sending its
  next request when its last one has finished): a stream of requests in
  blocks, each block taking one size from each of ``strata`` equal ranges
  of the prompt sizes and, independently, of the output sizes, so any
  prefix of the stream is balanced; the pool is gone through again when it
  runs out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Draw:
    """One request as the traffic sends it."""

    index: int
    prompt: List[int]
    max_new_tokens: int


def quantile_sizes(dist: Dict[str, Any], n: int) -> np.ndarray:
    """n sizes at the quantiles (i + 1/2) / n of `dist`, ascending."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "loguniform":
        x = lo * (hi / lo) ** u
    elif dist["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


#: the fixed order of the sizes, the same for every seed
ORDER = 20251018


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


class Traffic:
    """The requests of one mix for one seed."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        self.mix = mix
        self.mode = mix["mode"]
        self.seed = seed
        self.vocab = vocab
        self._tokens = _rng(seed, 1)
        if self.mode == "closed_batch":
            sizes = quantile_sizes(mix["prompt"], mix["sessions"])
            self._prompts = _rng(ORDER, 2).permutation(sizes)
        elif self.mode == "closed_loop":
            self.clients = mix["clients"]
            self._order = _rng(ORDER, 3)
        else:
            raise ValueError(f"unknown traffic mode {self.mode!r}")

    def _prompt(self, n: int) -> List[int]:
        return self._tokens.integers(1, self.vocab, size=n).tolist()

    def sessions(self) -> List[Draw]:
        """closed_batch: every session, in submit order."""
        out = []
        new = self.mix["output"]["tokens"]
        for i, n in enumerate(self._prompts.tolist()):
            out.append(Draw(i, self._prompt(n), new))
        return out

    def stream(self) -> Iterator[Draw]:
        """closed_loop: an endless stream of requests, balanced in blocks
        of one size from each stratum."""
        strata = self.mix["strata"]
        pool = self.mix["pool"]
        prompts = quantile_sizes(self.mix["prompt"], pool).reshape(strata, -1)
        outputs = quantile_sizes(self.mix["output"], pool).reshape(strata, -1)
        index = 0
        while True:
            p = [self._order.permutation(row) for row in prompts]
            o = [self._order.permutation(row) for row in outputs]
            for j in range(pool // strata):
                block_p = self._order.permutation([row[j] for row in p])
                block_o = self._order.permutation([row[j] for row in o])
                for n, new in zip(block_p.tolist(), block_o.tolist()):
                    yield Draw(index, self._prompt(n), int(new))
                    index += 1


def check(mix: Dict[str, Any]) -> None:
    """Raises where a mix cannot be served as written."""
    eng = mix["engine"]
    top = max(eng["prefill_buckets"])
    hi = mix["prompt"]["hi"]
    if hi > top:
        raise ValueError(f"prompts up to {hi} but the largest bucket is {top}")
    if mix["mode"] == "closed_batch":
        if hi + mix["output"]["tokens"] > eng["max_seq"]:
            raise ValueError("prompt + output exceeds max_seq")
    if mix["mode"] == "closed_loop":
        if mix["pool"] % mix["strata"]:
            raise ValueError("pool must be a multiple of strata")
        if hi + mix["output"]["hi"] > eng["max_seq"]:
            raise ValueError("prompt + output exceeds max_seq")
    if eng["max_seq"] % eng["page_tokens"]:
        raise ValueError("max_seq must be a multiple of page_tokens")
    if eng.get("hot_pages") and mix["mode"] == "closed_batch":
        need = session_pages(mix)
        if eng["hot_pages"] < need:
            raise ValueError(f"hot_pages {eng['hot_pages']} < the {need} "
                             "pages the sessions can fill")


def session_pages(mix: Dict[str, Any]) -> int:
    """closed_batch: the hot pages its sessions can hold at most, each
    session's prompt and every token it asks for (and one page ahead)."""
    P = mix["engine"]["page_tokens"]
    sizes = quantile_sizes(mix["prompt"], mix["sessions"])
    new = mix["output"]["tokens"]
    return int(np.sum(-(-(sizes + new + 1) // P) + 1))
