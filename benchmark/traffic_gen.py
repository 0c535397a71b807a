"""The one generator of every traffic mix: a mix is a JSON file under
``traffic/`` (its parameters), and this module turns it and the run's
seed into each stream's sequence of queries.

A mix names its ``template`` (the query text, with ``{NAME}`` for each
binding) and its ``bindings``, each drawn by one of these kinds:

- ``uniform_int``: an integer uniform in [lo, hi];
- ``choice``: one of ``values``, each as likely;
- ``date_minus_days``: the ISO date ``base`` less a whole number of days
  uniform in [lo, hi].

``draw`` is ``with_replacement`` (each query draws every binding anew,
each stream from its own generator) or ``without_replacement`` (one
permutation of all binding tuples from the seed, dealt to the streams in
turn, so no query text repeats in a run).
"""

from __future__ import annotations

import datetime
import itertools
from typing import Dict, Iterator, List

import numpy as np


def _domain(spec: dict) -> list:
    kind = spec["kind"]
    if kind == "uniform_int":
        return list(range(int(spec["lo"]), int(spec["hi"]) + 1))
    if kind == "choice":
        return list(spec["values"])
    if kind == "date_minus_days":
        base = datetime.date.fromisoformat(spec["base"])
        return [(base - datetime.timedelta(days=d)).isoformat()
                for d in range(int(spec["lo"]), int(spec["hi"]) + 1)]
    raise ValueError(f"unknown binding kind {kind!r}")


def _draw(spec: dict, rng: np.random.Generator):
    dom = _domain(spec)
    return dom[int(rng.integers(0, len(dom)))]


def render(template: str, binding: Dict[str, object]) -> str:
    return template.format(**binding)


def stream_bindings(traffic: dict, seed: int,
                    streams: int) -> List[Iterator[Dict[str, object]]]:
    """One endless (or, without replacement, finite) iterator of binding
    dicts a stream; the same seed gives the same sequences."""
    specs = traffic["bindings"]
    names = sorted(specs)
    if traffic["draw"] == "without_replacement":
        space = list(itertools.product(*(_domain(specs[n]) for n in names)))
        perm = np.random.default_rng([seed, 1]).permutation(len(space))
        return [iter([dict(zip(names, space[j]))
                      for j in perm[i::streams].tolist()])
                for i in range(streams)]
    if traffic["draw"] != "with_replacement":
        raise ValueError(f"unknown draw {traffic['draw']!r}")

    def stream(i: int) -> Iterator[Dict[str, object]]:
        rng = np.random.default_rng([seed, 1, i])
        while True:
            yield {n: _draw(specs[n], rng) for n in names}
    return [stream(i) for i in range(streams)]
