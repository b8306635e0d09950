"""Roofline terms of a dry-run cell (the port of
``repro.launch.roofline``).

Per (arch × shape × mesh), from one device's counts of the step
(``launch/op_analysis.py``: the local ops it runs, its kernels' costs, the
collectives it starts):

    compute term    = FLOPs / PEAK_FLOPS
    memory term     = bytes / HBM_BW
    collective term = collective bytes / LINK_BW

MODEL_FLOPS is the analytic 6·N_active·D (train) / 2·N·D (inference), N
without the embeddings; the GR models take 6·N_dense over 0.6 of the
packed capacity (the jagged fill). MODEL_FLOPS / FLOPs exposes recompute
and redundancy.

The constants are the H100 80GB HBM3 SXM's (700 W) specification figures,
not measurements, where the reference has TPU v5e's.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Mapping, Tuple, Union

from repro_torch.configs.base import ArchConfig, count_active_params
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.kernels.cost import PEAK_BYTES
from repro_torch.obs.derived import PEAK_FLOPS as _CARD_PEAKS
from repro_torch.obs.derived import gr_dense_params

#: The card the constants are for (``torch.cuda.get_device_name``).
CARD = "NVIDIA H100 80GB HBM3"
#: Dense bf16 tensor-core peak, H100 SXM5 (NVIDIA H100 datasheet, 700 W):
#: the port's one source of peaks, ``obs.PEAK_FLOPS``. FLOP/s.
PEAK_FLOPS = _CARD_PEAKS[CARD]["bfloat16"]
#: HBM3 bandwidth, H100 SXM5 datasheet: 3.35 TB/s (``kernels.cost``).
HBM_BW = PEAK_BYTES
#: One 400 Gb/s NIC per GPU, as in a DGX H100 (8 ConnectX-7 for 8 GPUs):
#: 50 GB/s. Every axis of the production meshes spans more than one
#: 8-GPU node (``model``'s 16 consecutive ranks two nodes, ``data``
#: strides by 16), so the NIC paces a ring on every axis. Bytes/s.
LINK_BW = 50e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    hlo_flops: float                 # the port's counted FLOPs (no HLO)
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    # derived terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float               # per-device analytic
    useful_ratio: float              # model_flops / hlo_flops
    roofline_frac: float             # model_flops/peak / max(term)
    step_tokens: int
    notes: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def model_flops_per_step(cfg: ArchConfig, shape: ShapeConfig
                         ) -> Tuple[float, int]:
    """(global analytic FLOPs per step, tokens per step)."""
    if cfg.gr:
        n = gr_dense_params(cfg)
        # jagged: valid tokens ≈ mean fill of the packed capacity
        tokens = int(shape.global_batch * shape.seq_len * 0.6)
        return 6.0 * n * tokens, tokens
    n_act = count_active_params(cfg)
    emb = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        emb *= 2
    n = max(n_act - emb, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens, tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens, tokens
    tokens = shape.global_batch          # decode: one token per sequence
    return 2.0 * n * tokens, tokens


def analyze(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str, chips: int,
            totals: Union[Mapping[str, Any], Any], notes: str = ""
            ) -> Roofline:
    """The roofline of one device's ``totals`` (an ``op_analysis.Totals``
    or its ``to_dict()``)."""
    t = totals.to_dict() if hasattr(totals, "to_dict") else dict(totals)
    flops = float(t["flops"])
    byts = float(t["bytes"])
    coll = {k: int(v) for k, v in t["coll_bytes"].items()}
    coll_total = float(sum(coll.values()))

    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    gflops, tokens = model_flops_per_step(cfg, shape)
    mflops_dev = gflops / chips
    useful = mflops_dev / flops if flops else 0.0
    ideal_s = mflops_dev / PEAK_FLOPS
    bound_s = max(terms.values())
    frac = ideal_s / bound_s if bound_s else 0.0

    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll_total,
        coll_by_kind=coll, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=mflops_dev, useful_ratio=useful, roofline_frac=frac,
        step_tokens=tokens, notes=notes)
