#!/usr/bin/env python3
"""How far Mamba's segment reset is from running each segment alone, in
both packages (CPU, fp32): ``ssd_chunked`` with ``seg`` on rows of packed
sequences against each sequence alone, and the two packages against each
other. The reset writes -1e9 into dt·A at a boundary, which an fp32
cumulative sum carries: within the boundary's chunk the decays between
later positions are differences of two sums near -1e9, whose ulp is 64.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/mamba_seg_reset.py
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.models import mamba as JM            # noqa: E402
from repro_torch.models import mamba as PM      # noqa: E402

B, S, H, P, N, CHUNK = 2, 96, 4, 8, 16, 32
SEGMENTS = {0: [(0, 30), (30, 71), (71, 96)], 1: [(0, 50), (50, 96)]}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
        np.float32) * 0.3
    A = -np.exp(rng.uniform(0, 1.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def alone(args, b, lo, hi):
    """One segment run by itself, padded to whole chunks with dt = 0."""
    x, dt, A, Bm, Cm = args
    pad = (-(hi - lo)) % CHUNK

    def cut(a):
        return np.pad(a[b:b + 1, lo:hi],
                      [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    y, _ = PM.ssd_chunked(*(torch.from_numpy(cut(a)) for a in (x, dt)),
                          torch.from_numpy(A),
                          *(torch.from_numpy(cut(a)) for a in (Bm, Cm)),
                          CHUNK)
    return y.numpy()[0, :hi - lo]


def main() -> int:
    args = inputs()
    seg = np.zeros((B, S), np.int32)
    for b, segs in SEGMENTS.items():
        for k, (lo, hi) in enumerate(segs):
            seg[b, lo:hi] = k
    yp, _ = PM.ssd_chunked(*(torch.from_numpy(a) for a in args), CHUNK,
                           seg=torch.from_numpy(seg))
    yj, _ = JM.ssd_chunked(*(jnp.asarray(a) for a in args), CHUNK,
                           seg=jnp.asarray(seg))
    yp, yj = yp.numpy(), np.asarray(yj)
    print(f"[mamba_seg_reset] b {B}, S {S}, H {H}, P {P}, N {N}, chunk "
          f"{CHUNK}; max |output| {np.abs(yj).max():.3f}")
    for b, segs in SEGMENTS.items():
        for lo, hi in segs:
            t = alone(args, b, lo, hi)
            print(f"  row {b} [{lo}, {hi}): port - alone "
                  f"{np.abs(yp[b, lo:hi] - t).max():.3g}, reference - alone "
                  f"{np.abs(yj[b, lo:hi] - t).max():.3g}, port - reference "
                  f"{np.abs(yp[b, lo:hi] - yj[b, lo:hi]).max():.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
