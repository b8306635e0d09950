"""Derived gauges: measured MFU, token-load imbalance, pipeline goodput (the
port's copy of ``repro.obs.derived``).

- ``measured_mfu`` — model FLOPs per step over the *measured* step wall
  time against the card's peak (the paper's 54.71% MFU axis, which was
  measured on Ascend). The GR model FLOPs are ``6 × gr_dense_params × tokens``
  as in the reference; the peak is the card's, from :data:`PEAK_FLOPS` by
  the name the device reports, never a TPU figure.
- ``token_imbalance`` — makespan-relative imbalance of per-device token
  loads (the paper's 47% -> 2.4% axis), through
  ``core.load_balance.imbalance_ratio``.
- ``pipeline_goodput`` — busy/wall ratio of the stage-event stream (the
  paper's 94% utilisation axis), with the bubble ratio as its complement.

All guards: zero events / zero wall time / empty loads return zeros,
never divide-by-zero.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core import load_balance as LB
from repro_torch.core.pipeline import StageEvent
from repro_torch.obs.trace import busy_from_intervals

__all__ = ["PEAK_FLOPS", "gr_dense_params", "measured_mfu", "peak_flops_of",
           "pipeline_goodput", "token_imbalance"]

#: Dense (no sparsity) peak FLOP/s by card, keyed by the name
#: ``torch.cuda.get_device_name`` and ``nvidia-smi`` give, then by operand
#: dtype. NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 column: BF16 and
#: FP16 Tensor Core 1,979 TFLOP/s with 2:4 sparsity, 989.4 dense; FP32 (the
#: CUDA cores) 67 TFLOP/s. The same numbers bound the kernels in
#: ``chip_smoke.py``.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float16": 989.4e12,
                              "float32": 67e12},
}


def peak_flops_of(device_name: str, dtype: str = "bfloat16",
                  peak_flops: Optional[float] = None) -> float:
    """The peak a measured MFU is taken against: ``peak_flops`` when given,
    else the cited figure for ``device_name`` and ``dtype``. A card or
    dtype with no cited figure (the CPU included) raises."""
    if peak_flops is not None:
        if peak_flops <= 0:
            raise ValueError(f"peak_flops must be positive, not {peak_flops}")
        return float(peak_flops)
    by_dtype = PEAK_FLOPS.get(device_name)
    if by_dtype is None or dtype not in by_dtype:
        raise ValueError(
            f"no cited {dtype} peak for {device_name!r} (known: "
            f"{sorted(PEAK_FLOPS)}): pass peak_flops")
    return by_dtype[dtype]


def gr_dense_params(cfg: ArchConfig) -> int:
    """Analytic dense-backbone params of HSTU/FuXi (Table 1; the reference's
    ``launch/roofline.gr_dense_params``)."""
    d, L = cfg.d_model, cfg.num_layers
    H = cfg.num_heads
    dqk = cfg.qkv_dim or cfg.resolved_head_dim
    per = d * H * 4 * dqk + H * dqk * d          # f1 (d→4d) + f2 (d→d)
    if cfg.gr_block == "fuxi":
        per += 3 * d * cfg.d_ff                  # gated interaction FFN
    return L * per


def measured_mfu(model_flops: float, wall_s: float,
                 peak_flops: float) -> float:
    """Measured model-FLOPs utilisation of one step: ``model_flops`` over
    ``wall_s`` seconds against ``peak_flops`` FLOP/s (see
    :func:`peak_flops_of`). 0.0 when any of them is non-positive."""
    if wall_s <= 0.0 or model_flops <= 0.0 or peak_flops <= 0.0:
        return 0.0
    return float(model_flops) / (float(wall_s) * float(peak_flops))


def token_imbalance(loads: Sequence[float]) -> float:
    """Makespan-relative token-load imbalance across devices:
    ``(max - mean) / max`` over per-device token loads (e.g. a jagged
    batch's ``offsets[:, -1]``). 0.0 for empty/zero loads or one device."""
    loads = [float(x) for x in loads]
    if len(loads) < 2 or max(loads) <= 0.0:
        return 0.0
    return float(LB.imbalance_ratio((), (), loads=loads))


def pipeline_goodput(events: Iterable[StageEvent]) -> Dict[str, float]:
    """Goodput / bubble ratio of a stage-event stream: busy time is the
    interval *union* across all stages, wall is first start to last end,
    bubble ratio ``1 - goodput``. Zero events -> all-zero dict."""
    ivs: list = [(ev.start, ev.end) for ev in events]
    if not ivs:
        return {"wall_s": 0.0, "busy_s": 0.0, "goodput": 0.0,
                "bubble_ratio": 0.0}
    wall = max(e for _, e in ivs) - min(s for s, _ in ivs)
    busy = busy_from_intervals(ivs)
    if wall <= 0.0:
        return {"wall_s": 0.0, "busy_s": busy, "goodput": 0.0,
                "bubble_ratio": 0.0}
    goodput = busy / wall
    return {"wall_s": wall, "busy_s": busy, "goodput": goodput,
            "bubble_ratio": max(0.0, 1.0 - goodput)}
