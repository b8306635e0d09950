"""Input-shape cells of the LM configs (the port's copy of the JAX
package's ``repro.configs.shapes``).

Each LM arch is paired with 4 shapes. ``decode_*``/``long_*`` run a decode
step (one new token against a cache of ``seq_len``), not a train step.
``long_500k`` needs sub-quadratic attention and so runs only for SSM and
hybrid archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)

# The paper's own GR workloads (Table 1 scale: seq 2048/4096, jagged
# batches); global_batch is users per step.
GR_TRAIN_2K = ShapeConfig("gr_train_2k", 2_048, 2_048, "train")
GR_TRAIN_4K = ShapeConfig("gr_train_4k", 4_096, 1_024, "train")
GR_SHAPES: Tuple[ShapeConfig, ...] = (GR_TRAIN_2K, GR_TRAIN_4K)

SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES + GR_SHAPES}


def shapes_for(arch: ArchConfig) -> Tuple[ShapeConfig, ...]:
    return GR_SHAPES if arch.gr else ALL_SHAPES


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if arch.gr and not shape.name.startswith("gr_"):
        return False, "skip: GR archs use the paper's jagged train shapes"
    if shape.name == "long_500k":
        if arch.ssm is None:
            return False, ("skip: pure full-attention arch — long_500k needs "
                           "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def cells_for(arch: ArchConfig):
    """All (shape, runnable, reason) cells for an arch."""
    return [(s,) + shape_applicable(arch, s) for s in shapes_for(arch)]
