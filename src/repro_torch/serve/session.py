"""Session descriptors and synthetic traffic for the serving layer (a copy
of `repro/serve/session.py`).

A *session* is one client-owned simulation: a network size, a step budget,
optional per-session kernel knobs, and an RNG seed.  The service
(serve/service.py) packs live sessions into the replica axis of one
batched step, so a session spends its life migrating between states:

    QUEUED -> RUNNING -> (EVICTED <-> RUNNING)* -> FINISHED

EVICTED sessions live on disk as checkpoints (checkpoint/manager.py) and
re-enter RUNNING — possibly in a *different* slot — when the client wakes
up.  The bitwise contract (DESIGN.md §14, tests/test_torch_serve.py) is
that none of this is observable: records and probe rows equal an isolated
`PlasticityEngine.simulate` of the session's own size.

`TrafficGenerator` produces the TGI-style synthetic workload the
integration harness replays: staggered arrivals, heterogeneous sizes and
step budgets, and random idle gaps that force evict/restore churn.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Session lifecycle states (string enums keep checkpoint manifests and
# test assertions trivially readable).
QUEUED = "queued"
RUNNING = "running"
EVICTED = "evicted"
FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SessionRequest:
    """One client request: simulate `n_neurons` for `num_steps` steps.

    session_id: unique client-chosen name (keys checkpoints and results).
    n_neurons:  active network size; must be <= the service's pool size.
                The session runs in a padded slot with
                n_active = n_neurons over the pool's position prefix.
    num_steps:  total steps the client wants; any positive int (sessions
                finishing mid-round freeze in place until harvested).
    seed:       per-session RNG seed — the stream an isolated
                `simulate(noise=CounterNoise(seed))` would draw.
    idle_after: optional step count after which the client goes idle; at
                the first round boundary past it the service evicts the
                session to a checkpoint.
    idle_rounds: how many rounds the idle gap lasts before the session is
                eligible for restore (ignored when idle_after is None).
    record_probes: request the service's probe set for this session (the
                ProbeSet itself is service-level static config, shared by
                every session).
    """

    session_id: str
    n_neurons: int
    num_steps: int
    seed: int = 0
    idle_after: Optional[int] = None
    idle_rounds: int = 1
    record_probes: bool = False

    def __post_init__(self):
        if self.n_neurons <= 0:
            raise ValueError(f"n_neurons must be positive: {self.n_neurons}")
        if self.num_steps <= 0:
            raise ValueError(f"num_steps must be positive: {self.num_steps}")
        if self.idle_after is not None and self.idle_after <= 0:
            raise ValueError(f"idle_after must be positive: {self.idle_after}")


@dataclasses.dataclass
class Session:
    """Mutable service-side view of one request (host bookkeeping only; the
    batched step sees just the slot's (n_active, target) extras).
    """

    request: SessionRequest
    status: str = QUEUED
    slot: Optional[int] = None
    steps_done: int = 0
    idled: bool = False  # the one idle gap has been taken
    idle_until_round: int = -1  # round index at which restore is allowed
    # per-field record rows harvested so far, in step order (host tensors
    # appended round by round, concatenated at result time)
    record_chunks: List = dataclasses.field(default_factory=list)
    # set on finish (host tensors): full-slot-width final state, and — for
    # record_probes sessions — probe name -> (num_steps, ...) rows
    final_state: Optional[object] = None
    probe_rows: Optional[dict] = None

    @property
    def remaining(self) -> int:
        return self.request.num_steps - self.steps_done


class TrafficGenerator:
    """Seeded synthetic arrival process for the integration harness.

    Draws `num_sessions` requests with:
      * arrival rounds stepped by Geometric(p_arrival) gaps (staggered
        admissions — some rounds get bursts, some none);
      * n_neurons uniform over [n_lo, n_hi] (heterogeneous padded slots);
      * num_steps a uniform multiple of `step_quantum` in
        [1, max_steps/step_quantum], plus a uniform remainder when
        `ragged_steps` — so some sessions finish mid-round;
      * an idle gap (evict/restore churn) with probability p_idle.

    Deterministic for a fixed seed: the harness replays the same traffic
    against the service and against isolated engines.
    """

    def __init__(
        self,
        seed: int,
        num_sessions: int,
        n_lo: int,
        n_hi: int,
        max_steps: int,
        step_quantum: int,
        p_arrival: float = 0.6,
        p_idle: float = 0.3,
        ragged_steps: bool = True,
    ):
        if not (0 < n_lo <= n_hi):
            raise ValueError(f"bad size range [{n_lo}, {n_hi}]")
        if max_steps < step_quantum:
            raise ValueError("max_steps must cover one step_quantum")
        self.seed = seed
        self.num_sessions = num_sessions
        self.n_lo, self.n_hi = n_lo, n_hi
        self.max_steps = max_steps
        self.step_quantum = step_quantum
        self.p_arrival = p_arrival
        self.p_idle = p_idle
        self.ragged_steps = ragged_steps

    def generate(self) -> List[Tuple[int, SessionRequest]]:
        """Returns [(arrival_round, request), ...] sorted by arrival."""
        rng = np.random.default_rng(self.seed)
        out: List[Tuple[int, SessionRequest]] = []
        round_idx = 0
        for i in range(self.num_sessions):
            if i > 0 and rng.random() > self.p_arrival:
                round_idx += int(rng.integers(1, 3))
            n = int(rng.integers(self.n_lo, self.n_hi + 1))
            quanta = self.max_steps // self.step_quantum
            steps = int(rng.integers(1, quanta + 1)) * self.step_quantum
            if self.ragged_steps and rng.random() < 0.5:
                steps = max(1, steps - int(rng.integers(1, self.step_quantum)))
            idle_after = None
            idle_rounds = 1
            if rng.random() < self.p_idle and steps > self.step_quantum:
                # pause somewhere strictly inside the run
                idle_after = int(rng.integers(1, steps))
                idle_rounds = int(rng.integers(1, 3))
            req = SessionRequest(
                session_id=f"s{i:03d}",
                n_neurons=n,
                num_steps=steps,
                seed=int(rng.integers(0, 2**31 - 1)),
                idle_after=idle_after,
                idle_rounds=idle_rounds,
                record_probes=bool(rng.random() < 0.5),
            )
            out.append((round_idx, req))
        return out
