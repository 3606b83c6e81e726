"""The paper's workload at 256 and 512 ranks, as counters (the port of
`repro/launch/brain_dryrun.py`, which lowers and compiles one sharded step
on forced host devices; the port has no lowering to inspect).

The per-rank work and payload of one connectivity update come from the
static layout alone, so no process group is needed: the engine is built
over a `ShapeGroup` of the rank count, on the CPU.

    python -m repro_torch.launch.brain_dryrun [--n-per-rank 512] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.distributed import DistributedPlasticityEngine
from repro_torch.core.engine import EngineConfig
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch.mesh import ShapeGroup


def census(positions: np.ndarray, ranks: int, engine_cfg: EngineConfig,
           fmm_cfg: FMMConfig = FMMConfig()) -> dict:
    """The static counters of `positions` over `ranks` ranks: the find
    phase's work and payload (sharded and replicated), the pyramid
    exchange's payload (gathered and routed) and the pyramid's segment-sum
    elements (owner_span and masked), each on the busiest rank."""
    eng = DistributedPlasticityEngine(positions, ShapeGroup(ranks), MSPConfig.calibrated(),
                                      fmm_cfg, engine_cfg, device="cpu")
    return {
        "ranks": ranks, "neurons": eng.n, "octree_depth": eng.structure.depth,
        "find_phase_work": {m: eng.find_phase_work(m) for m in ("sharded", "replicated")},
        "pyramid_exchange_payload": {m: eng.pyramid_exchange_payload(m)["pyramid_payload_elements"]
                                     for m in ("gathered", "routed")},
        "pyramid_elements_per_device": {m: eng.pyramid_elements_per_device(m)
                                        for m in ("owner_span", "masked")},
    }


def run(n_per_rank: int, ranks: int) -> dict:
    """The reference's dry-run configuration: U(0, 2000 um)^3, seed 0,
    paper FMMConfig, method "fmm"."""
    n = n_per_rank * ranks
    pos = np.random.default_rng(0).uniform(0, 2000.0, (n, 3)).astype(np.float32)
    return census(pos, ranks, EngineConfig(method="fmm", domain=2000.0))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-rank", type=int, default=512)
    ap.add_argument("--out", default=None, help="write the census as JSON here")
    args = ap.parse_args(argv)
    out = {}
    for ranks in (256, 512):
        out[ranks] = c = run(args.n_per_rank, ranks)
        print(f"[brain census] {ranks} ranks x {args.n_per_rank} neurons: depth "
              f"{c['octree_depth']}, find phase {c['find_phase_work']['sharded']}, pyramid "
              f"exchange {c['pyramid_exchange_payload']}, pyramid elements "
              f"{c['pyramid_elements_per_device']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
