"""The general traffic generator: a traffic mix is a data file
(``zkbench/traffic/<name>.json``) of parameters, and this module turns it
and ``--seed`` into the work of each step of a run.

Parameters:

- ``loop``: ``"closed"``, one client that sends its next step once the
  last is answered (the only kind so far).
- ``batch``: requests a step.
- ``distinct``: requests made in set-up; the steps take them in order,
  cycled.
- ``check_share``: the share of the window's answers the reference
  judges (1: every one); answer j is judged or not by a draw from the seed
  and j alone, so the choice does not wait for the window's end and the
  answers not judged need not be kept.

A step's requests take the blinding seeds ``seed * 2^20 + j`` for the j-th
request of the run, so no two proofs of a run share a blinding and the
same seed gives the same run.
"""

from __future__ import annotations

import random

BLIND_SHIFT = 20
WARMUP_BLIND = 1        # blinding seeds of the set-up's warm step: 1, 2, ...


class ClosedLoop:
    def __init__(self, params: dict, seed: int):
        if params.get("loop", "closed") != "closed":
            raise ValueError(f"traffic loop {params['loop']!r}")
        self.batch = int(params["batch"])
        self.distinct = int(params["distinct"])
        self.check_share = float(params.get("check_share", 1.0))
        self.seed = seed

    def step(self, k: int) -> tuple:
        """(request indices, blinding seed of the first) of step k."""
        first = k * self.batch
        idx = [(first + j) % self.distinct for j in range(self.batch)]
        return idx, (self.seed << BLIND_SHIFT) + first

    def warmup(self) -> tuple:
        """The set-up's warm step: the first batch, other blinding seeds."""
        return [j % self.distinct for j in range(self.batch)], WARMUP_BLIND

    def judged(self, j: int) -> bool:
        """Whether the reference judges the run's j-th answer."""
        if self.check_share >= 1.0:
            return True
        return random.Random((self.seed << BLIND_SHIFT) ^ j ^ 0x5A17) \
            .random() < self.check_share
