"""Simulation core of the port: neuron dynamics, synapses, octree, descent
(port of `repro.core`).

Public surface, re-exported as the reference's package does (importing the
submodule directly is equally supported):

  engine        PlasticityEngine, SimState, StepRecord, KernelParams,
                EngineConfig — the single-device simulation loop
  msp           MSPConfig, NeuronState — neuron/calcium/element dynamics
  synapses      SynapseState, insert, insert_span — the slot-table edge store
  octree        build_structure, owner_spans, OwnerSpans — Morton pyramid
  expansions    LOG_EPS — the log-space weight floor
  ensemble      EnsembleEngine — K replicas, one program (the reference's
                `scan_replicas` has no counterpart: its semantics hold inside
                `EnsembleEngine`)
  distributed   DistributedPlasticityEngine, DistributedEnsembleEngine
  probes        ProbeSet, ProbeState, SpikeRasterProbe, CalciumProbe,
                TurnoverProbe, ProbeWriter, read_trajectory,
                simulate_chunked, apply_lesion
"""

from repro_torch.core.engine import (
    EngineConfig,
    KernelParams,
    PlasticityEngine,
    SimState,
    StepRecord,
)
from repro_torch.core.msp import MSPConfig, NeuronState
from repro_torch.core.synapses import SynapseState, insert, insert_span
from repro_torch.core.octree import OwnerSpans, build_structure, owner_spans
from repro_torch.core.expansions import LOG_EPS
from repro_torch.core.ensemble import EnsembleEngine
from repro_torch.core.distributed import (
    DistributedEnsembleEngine,
    DistributedPlasticityEngine,
)
from repro_torch.core.probes import (
    CalciumProbe,
    ProbeSet,
    ProbeState,
    ProbeWriter,
    SpikeRasterProbe,
    TurnoverProbe,
    apply_lesion,
    read_trajectory,
    simulate_chunked,
)

__all__ = [
    "EngineConfig",
    "KernelParams",
    "PlasticityEngine",
    "SimState",
    "StepRecord",
    "MSPConfig",
    "NeuronState",
    "SynapseState",
    "insert",
    "insert_span",
    "OwnerSpans",
    "build_structure",
    "owner_spans",
    "LOG_EPS",
    "EnsembleEngine",
    "DistributedEnsembleEngine",
    "DistributedPlasticityEngine",
    "CalciumProbe",
    "ProbeSet",
    "ProbeState",
    "ProbeWriter",
    "SpikeRasterProbe",
    "TurnoverProbe",
    "apply_lesion",
    "read_trajectory",
    "simulate_chunked",
]
