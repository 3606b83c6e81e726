"""The one traffic generator: a parameter sweep run in episodes.

A mix file (`bench/traffic/<name>.json`) gives

    replicas       {knob: [values, ...]}: one replica per point of the grid
                   (the knobs of `KernelParams`: sigma, c1, c2,
                   inhibitory_fraction), in that knob order;
    episode_steps  steps an episode runs before the next starts afresh;
    chunks         the steps of each timed chunk of an update interval
                   (they add up to the configuration's update interval);
    start          each episode's start state: `generator` names a module
                   `bench/starts/<generator>.py` whose `draw(params, gen,
                   positions, domain)` makes it on the device from the
                   group's other parameters (neuron fields and synapses).

Every input is made here from `--seed` and handed to both the program and
the reference: the positions (host numpy, uniform in the cube), each
episode's start state (drawn on the device), and the seed of every
replica's draws, from (seed, episode, replica).  Episode 0 is the set-up's
warm-up; the window's episodes are 1, 2, ...; the window ends with an
update interval.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

KNOBS = ("sigma", "c1", "c2", "inhibitory_fraction")
_POSITIONS, _START, _NOISE, _SAMPLE = range(4)


def _words(seed: int) -> int:
    """A whole number of any sign as a SeedSequence entry."""
    return int(seed) % (1 << 64)


def seed64(seed: int, *words: int) -> int:
    return int(np.random.SeedSequence([_words(seed), *words]).generate_state(1, np.uint64)[0])


def grid(traffic: dict) -> List[Dict[str, float]]:
    """One dict of knob values per replica (the Cartesian product)."""
    axes = traffic["replicas"]
    unknown = set(axes) - set(KNOBS)
    if unknown:
        raise ValueError(f"unknown replica knobs {sorted(unknown)}; knobs: {KNOBS}")
    names = [k for k in KNOBS if k in axes]
    return [dict(zip(names, map(float, vals)))
            for vals in itertools.product(*(axes[k] for k in names))]


def positions(seed: int, n: int, domain: float) -> np.ndarray:
    """n positions uniform in the cube [0, domain)^3, float32."""
    rng = np.random.default_rng(np.random.SeedSequence([_words(seed), _POSITIONS]))
    return rng.uniform(0, domain, (n, 3)).astype(np.float32)


class Start(NamedTuple):
    """An episode's start, alike in every replica: neuron fields and the
    synapses, which fill the edge table's first slots in this order."""
    fields: Dict[str, torch.Tensor]   # calcium, ax_elems, den_elems: (n,) float32
    src: torch.Tensor                 # (E,) int32
    dst: torch.Tensor                 # (E,) int32


def start(draw, traffic: dict, seed: int, episode: int, positions: torch.Tensor,
          domain: float) -> Start:
    """Episode `episode`'s start state, drawn on the device of `positions`
    by the mix's generator (`draw`, the `draw` of its module)."""
    gen = torch.Generator(device=positions.device).manual_seed(seed64(seed, _START, episode))
    fields, src, dst = draw(traffic["start"], gen, positions, domain)
    return Start(fields=fields, src=src, dst=dst)


def noise_seed(seed: int, episode: int, replica: int) -> int:
    """The seed of replica `replica`'s draws in episode `episode`."""
    return seed64(seed, _NOISE, episode, replica)


def checked_replicas(seed: int, num_replicas: int) -> List[int]:
    """A seeded order of the replicas: interval i of the window keeps
    replica [i % K]'s states for the comparison, so that K intervals cover
    every replica once.  The order alternates between the batch's two
    halves, so that any two intervals in a row check both."""
    rng = np.random.default_rng(np.random.SeedSequence([_words(seed), _SAMPLE]))
    half = num_replicas // 2
    lo, hi = rng.permutation(half), half + rng.permutation(num_replicas - half)
    order = [int(k) for pair in zip(hi, lo) for k in pair]
    return order + [int(k) for k in hi[len(lo):]]


def checked_intervals(seed: int, num_intervals: int, count: int) -> List[int]:
    """Which of the window's intervals are compared: `count` of them (all when
    there are no more), drawn from the seed, in order."""
    if num_intervals <= count:
        return list(range(num_intervals))
    rng = np.random.default_rng(np.random.SeedSequence([_words(seed), _SAMPLE, 1]))
    return sorted(int(i) for i in rng.choice(num_intervals, size=count, replace=False))
