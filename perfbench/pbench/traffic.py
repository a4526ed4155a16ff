"""The one traffic generator: a mix file's parameters -> requests and
their arrival steps.

A mix fixes a block of request sizes and arrival gaps once, from the mix
itself: ``block`` requests whose lengths and gaps sit at the quantiles of
the mix's distributions (a documents mix with ``first`` also asks one
question on each document at step 0).  Every run repeats that block for
as long as it needs requests, each time in another order; the orders are
drawn from the mix's name too, not from ``--seed``, which writes only the
text.  So every seed sends the same sizes at the same steps, and any
``block`` requests in a row hold the whole distribution.  A tail such as
the 95th percentile of the gap between tokens lands on the few steps that
prefill the most prompts at once, and how many of those a window holds
follows the order: an order drawn from the seed moved it more between
seeds than between two runs of one seed.

A mix with ``"start": "stationary"`` begins where its steady state would
be, not from an empty pool: at step 0 it sends the requests that would
be in flight then, as many as the load keeps busy (``load`` x slots),
each a request caught part way through its answer.  An answer in flight
is length-biased (a long one is in flight for longer), and its age is
uniform over it, so each takes a total answer length at the quantiles of
the block's length-biased distribution and an age at a uniform quantile;
the part already answered joins its prompt, and the rest is what it
asks for.  The arrivals that follow start at ``start_steps``, which
``rehearse.py`` sets to half the steps that prefilling them takes (they
start to answer halfway through on average), so the live slots stay
near their steady mean.  The warm-up then only prefills them, where an
empty pool would take a whole answer's length of steps to fill.

Arrivals are Poisson in scheduler steps: the gaps are exponential with
mean ``1 / rate_per_step``, the rate that ``rehearse.py`` works out from
the mix's lengths (a share ``load`` of the slots' capacity) and writes
into the mix's file.  Prompts are seeded printable ASCII; the port's
tokenizer is byte-level with a leading BOS, so a prompt of n tokens is
n - 1 characters.  A mix with ``documents`` prefixes every prompt with one
of a few seeded documents, picked at random, and ``prompt_tokens`` then
sizes the question after it.
"""
from __future__ import annotations

import dataclasses
import zlib
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

ASCII = np.frombuffer(bytes(range(32, 127)), np.uint8)


@dataclasses.dataclass
class Item:
    """One request before it becomes the program's ``Request``."""
    prompt: str
    prompt_tokens: int          # with the BOS
    max_new_tokens: int
    arrive_step: int
    doc: int = -1               # the shared document, or -1


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(spec: Dict, n: int) -> np.ndarray:
    """The distribution's n quantiles, floored and clipped to its range."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = _quantiles(n)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(v) for v in u])
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo + 1)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def master_block(mix: Dict) -> Dict[str, np.ndarray]:
    """The mix's fixed block of ``block`` requests, the same for every
    seed: prompt and output lengths at the quantiles of their
    distributions (paired at random, once, from the mix's name), arrival
    gaps at the exponential's quantiles (in units of the mean gap), and
    the documents in turn."""
    n = int(mix["block"])
    rng = np.random.default_rng(zlib.crc32(mix["name"].encode()))
    docs = mix.get("documents")
    return {
        "prompt": _lengths(mix["prompt_tokens"], n),
        "output": rng.permutation(_lengths(mix["output_tokens"], n)),
        "gap": -np.log1p(-_quantiles(n)),
        "doc": (np.arange(n) % docs["count"] if docs else np.full(n, -1)),
    }


def in_flight(mix: Dict, block: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The requests a stationary start sends at step 0: prompt tokens
    (with the answer so far) and the answer still to come, fixed by the
    mix alone."""
    n = int(round(float(mix["load"]) * int(mix["serving"]["max_batch"])))
    rng = np.random.default_rng(zlib.crc32((mix["name"] + "/start").encode()))
    out = np.sort(block["output"])
    biased = np.cumsum(out) / out.sum()
    total = out[np.minimum(np.searchsorted(biased, _quantiles(n)), len(out) - 1)]
    age = np.floor(rng.permutation(_quantiles(n)) * total).astype(np.int64)
    prompt = rng.permutation(_lengths(mix["prompt_tokens"], n))
    return {"prompt": prompt + age, "output": total - age}


def _text(rng: np.random.Generator, n: int) -> str:
    return ASCII[rng.integers(0, len(ASCII), max(n, 0))].tobytes().decode()


def documents(mix: Dict, seed: int) -> List[str]:
    docs = mix.get("documents")
    if not docs:
        return []
    rng = np.random.default_rng([int(seed), 1])
    return [_text(rng, int(docs["tokens"]) - 1) for _ in range(docs["count"])]


def generate(mix: Dict, seed: int, horizon_steps: int,
             rate_per_step: Optional[float] = None,
             start_steps: Optional[int] = None) -> List[Item]:
    """Requests arriving in steps [0, horizon_steps), in arrival order.
    A document of n tokens is the BOS and n - 1 characters; the question
    follows it."""
    rate = float(rate_per_step if rate_per_step is not None
                 else mix["rehearsal"]["rate_per_step"])
    block = master_block(mix)
    n = len(block["prompt"])
    orders = np.random.default_rng(zlib.crc32((mix["name"] + "/order").encode()))
    rng = np.random.default_rng([int(seed), 0])     # the text alone
    docs = documents(mix, seed)
    items: List[Item] = []
    if docs and mix["documents"].get("first"):
        # one question on each document at step 0, so that every document
        # is prefilled while the slots fill
        for d, text in enumerate(docs):
            j = int(np.flatnonzero(block["doc"] == d)[0])
            body = int(block["prompt"][j])
            items.append(Item(text + _text(rng, body), len(text) + 1 + body,
                              int(block["output"][j]), 0, d))
    if mix.get("start") == "stationary":
        flight = in_flight(mix, block)
        for j in orders.permutation(len(flight["prompt"])):
            body = int(flight["prompt"][j])
            items.append(Item(_text(rng, body - 1), body,
                              int(flight["output"][j]), 0))
    t = 0.0
    if mix.get("start") == "stationary":
        t = float(start_steps if start_steps is not None
                  else mix["rehearsal"]["start_steps"])
    while True:
        order = orders.permutation(n)
        for j in order:
            t += block["gap"][j] / rate
            step = int(t)
            if step >= horizon_steps:
                return items
            doc = int(block["doc"][j])
            body = int(block["prompt"][j])
            if doc >= 0:
                text = docs[doc] + _text(rng, body)
                tokens = len(docs[doc]) + 1 + body
            else:
                text = _text(rng, body - 1)
                tokens = body
            items.append(Item(text, tokens, int(block["output"][j]), step, doc))
