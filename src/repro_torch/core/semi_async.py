"""Semi-asynchronous training (paper §4.2.2 + Appendix C), the port of
``repro.core.semi_async``.

Sparse-asynchronous / dense-synchronous: the sparse (embedding) update at
step t applies the gradient produced at step t−1 (delay τ=1). The trainer
and the engine implement that dataflow themselves (``training/trainer.py``
keeps the unique pairs of step t−1 as the carry and lands them after step
t's input gather); the helpers here are the generic whole-table τ-delay
reference and the Appendix C quantities.

Convergence (Appendix C):  E‖∇f‖² ≤ O(√Lσ/√T + L/T + αLτ/T) — the delay
penalty is scaled by the feature-collision probability α, so for sparse
recommendation features (α ≪ 1) the trajectory is indistinguishable from
synchronous training. :func:`collision_alpha` measures α on an id stream;
:func:`delay_penalty_bound` evaluates the bound.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch


class SemiAsyncState(NamedTuple):
    """Carries the τ=1-delayed sparse gradient between steps."""
    pending_grad: Any          # sparse (table) grad from step t−1, or zeros
    step: int


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree)


def init_semi_async(table_like: Any) -> SemiAsyncState:
    """Zero fp32 pending grads shaped like ``table_like`` (a tensor or a
    nested dict / list / tuple of them)."""
    zeros = _tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                      table_like)
    return SemiAsyncState(pending_grad=zeros, step=0)


def semi_async_update(state: SemiAsyncState, new_sparse_grad: Any,
                      apply_fn: Callable[[Any], Any]
                      ) -> Tuple[Any, SemiAsyncState]:
    """Apply the *pending* (t−1) sparse gradient; stash the current one.

    ``apply_fn``: grad → whatever the optimizer produces (e.g. the updated
    table). Returns (apply_fn(pending), the new state carrying
    ``new_sparse_grad``). Step 0 applies zeros — the one-step warm-up of
    the dual-stream schedule (Fig. 8)."""
    out = apply_fn(state.pending_grad)
    return out, SemiAsyncState(pending_grad=new_sparse_grad,
                               step=state.step + 1)


# --------------------------------------------------------------------------
# Appendix C quantities
# --------------------------------------------------------------------------

def collision_alpha(id_batches: np.ndarray) -> float:
    """Empirical α: the probability that a feature id in step t+1's batch
    also appears in step t's batch (a collision across delayed updates).

    id_batches: (steps, n_ids) int array (or a list of 1-d id arrays)."""
    hits, total = 0, 0
    for t in range(len(id_batches) - 1):
        cur = np.unique(np.asarray(id_batches[t + 1]))
        prev = np.unique(np.asarray(id_batches[t]))
        hits += int(np.isin(cur, prev, assume_unique=True).sum())
        total += len(cur)
    return hits / max(total, 1)


def delay_penalty_bound(alpha: float, L: float, tau: int, T: int,
                        sigma: float = 1.0) -> float:
    """RHS of Appendix C Eq. 3 (up to constants)."""
    return float(np.sqrt(L) * sigma / np.sqrt(T) + L / T
                 + alpha * L * tau / T)


def delayed_sgd_trajectory(grad_fn: Callable[[torch.Tensor, int],
                                             torch.Tensor],
                           w0: torch.Tensor, lr: float, steps: int,
                           tau: int = 1, dtype: torch.dtype = torch.float64
                           ) -> torch.Tensor:
    """Reference implementation of τ-delayed SGD (the convergence tests
    compare it with the synchronous trajectory, ``tau=0``), in ``dtype``
    (the reference computes in its arrays' dtype: float64 for numpy
    inputs under x64, float32 otherwise, so the caller states it)."""
    w = w0.to(dtype)
    pending = [torch.zeros_like(w) for _ in range(tau)]
    for t in range(steps):
        g = grad_fn(w, t).to(dtype)
        if tau == 0:
            gd = g                      # synchronous reference
        else:
            gd = pending.pop(0)
            pending.append(g)
        w = w - lr * gd
    return w
