"""§4.2.2 / Appendix C (``repro_torch/core/semi_async.py``) against the
reference (``repro.core.semi_async``) on the same inputs: the τ=1 state
machine, α of sparse and dense id streams (exactly), the delay penalty
bound (exactly: the same float64 arithmetic), and τ-delayed SGD on a
quadratic (float32 in both; 1e-5: the products summed in another order
over 50–800 steps)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semi_async as JS
from repro_torch.core import semi_async as PS


def test_semi_async_update_state_machine_matches_reference():
    table = np.zeros((4, 2), np.float32)
    jst = JS.init_semi_async(jnp.asarray(table))
    pst = PS.init_semi_async(torch.from_numpy(table))
    for k in (1.0, 2.0, 3.0):
        g = np.full((4, 2), k, np.float32)
        ja, jst = JS.semi_async_update(jst, jnp.asarray(g), lambda x: x)
        pa, pst = PS.semi_async_update(pst, torch.from_numpy(g), lambda x: x)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        assert pst.step == int(jst.step)
    tree = {"a": torch.ones(3), "b": [torch.ones(2, 2)]}
    st = PS.init_semi_async(tree)
    assert st.pending_grad["b"][0].dtype == torch.float32
    assert float(st.pending_grad["a"].abs().sum()) == 0.0


def test_collision_alpha_matches_reference():
    rng = np.random.default_rng(0)
    for ids in (rng.integers(0, 1_000_000, size=(20, 64)),
                rng.integers(0, 16, size=(20, 64)),
                rng.zipf(1.1, size=(12, 500)) % 4096):
        assert PS.collision_alpha(ids) == JS.collision_alpha(ids)
    assert PS.collision_alpha(rng.integers(0, 1_000_000, (20, 64))) < 0.01
    assert PS.collision_alpha(rng.integers(0, 16, (20, 64))) > 0.9


@pytest.mark.parametrize("args", [(0.5, 1.0, 1, 100), (0.01, 1.0, 1, 100),
                                  (0.1, 2.0, 4, 100), (0.1, 1.0, 1, 10_000),
                                  (0.3, 0.5, 2, 7)])
def test_delay_penalty_bound_matches_reference(args):
    assert PS.delay_penalty_bound(*args) == JS.delay_penalty_bound(*args)
    assert PS.delay_penalty_bound(*args, sigma=2.0) == \
        JS.delay_penalty_bound(*args, sigma=2.0)


def test_delayed_sgd_trajectory_matches_reference():
    """Both trajectories in float32 on one quadratic, τ = 0, 1, 2; and the
    gap to the synchronous run shrinks with T (Appendix C)."""
    rng = np.random.default_rng(0)
    Q = rng.normal(size=(8, 8))
    A = (Q @ Q.T / 8 + np.eye(8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    pA, pb = torch.from_numpy(A), torch.from_numpy(b)
    w0 = np.zeros(8, np.float32)
    gaps = []
    for T in (50, 200, 800):
        for tau in (0, 1, 2):
            j = JS.delayed_sgd_trajectory(lambda w, t: jA @ w - jb,
                                          jnp.asarray(w0), 0.05, T, tau)
            p = PS.delayed_sgd_trajectory(lambda w, t: pA @ w - pb,
                                          torch.from_numpy(w0), 0.05, T,
                                          tau, dtype=torch.float32)
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)
        sync = PS.delayed_sgd_trajectory(lambda w, t: pA @ w - pb,
                                         torch.from_numpy(w0), 0.05, T, 0,
                                         dtype=torch.float32)
        late = PS.delayed_sgd_trajectory(lambda w, t: pA @ w - pb,
                                         torch.from_numpy(w0), 0.05, T, 1,
                                         dtype=torch.float32)
        gaps.append(float(torch.linalg.norm(late - sync)))
    assert gaps[-1] < gaps[0]
