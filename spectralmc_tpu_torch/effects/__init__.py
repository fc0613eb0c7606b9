"""Effect system: pure descriptions of orchestration, interpreted at the edge.

The JAX package's ``effects`` on PyTorch: 7 effect families as frozen
dataclasses with ``kind`` discriminators, a master ``Effect`` union,
sequence/parallel composition with continuations, a typed ``SharedRegistry``
data plane (tensors, and the CVNN module itself in its model slot), an async
interpreter per family routed by ``SpectralMCInterpreter`` (which takes an
explicit ``device``), and a recording ``MockInterpreter`` for device-free
orchestration tests. ``GbmCVNNPricer.train_via_effects`` drives a whole
training run through it.
"""

from spectralmc_tpu_torch.effects.types import (
    AdvanceCounter,
    BlockUntilReady,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    ComputeLoss,
    DeviceEffect,
    Effect,
    ForwardPass,
    GenerateNormals,
    GradientStep,
    HostDeviceTransfer,
    JitCall,
    LogMessage,
    LoggingEffect,
    LogMetrics,
    MetadataEffect,
    MonteCarloEffect,
    ReadMetadata,
    ReadObject,
    RestoreCounters,
    RngEffect,
    SimulatePaths,
    StorageEffect,
    TrainingEffect,
    TrainSegment,
    UpdateMetadata,
    WriteObject,
)
from spectralmc_tpu_torch.effects.composition import (
    EffectParallel,
    EffectSequence,
    map_effect,
    parallel_effects,
    sequence_effects,
)
from spectralmc_tpu_torch.effects.registry import FrozenRegistrySnapshot, SharedRegistry
from spectralmc_tpu_torch.effects.interpreter import SpectralMCInterpreter
from spectralmc_tpu_torch.effects.mock import MockInterpreter

__all__ = [
    "AdvanceCounter",
    "BlockUntilReady",
    "CaptureCounters",
    "CommitVersion",
    "ComputeFFT",
    "ComputeLoss",
    "DeviceEffect",
    "Effect",
    "EffectParallel",
    "EffectSequence",
    "ForwardPass",
    "FrozenRegistrySnapshot",
    "GenerateNormals",
    "GradientStep",
    "HostDeviceTransfer",
    "JitCall",
    "LogMessage",
    "LogMetrics",
    "LoggingEffect",
    "MetadataEffect",
    "MockInterpreter",
    "MonteCarloEffect",
    "ReadMetadata",
    "ReadObject",
    "RestoreCounters",
    "RngEffect",
    "SharedRegistry",
    "SimulatePaths",
    "SpectralMCInterpreter",
    "StorageEffect",
    "TrainSegment",
    "TrainingEffect",
    "UpdateMetadata",
    "WriteObject",
    "map_effect",
    "parallel_effects",
    "sequence_effects",
]
