"""The sharded LM equals the single process (the counterpart of
``tests/test_sharded_parity.py``): one ``make_lm_train_step`` step of
``reduced`` glm4-9b (dense), olmoe-1b-7b (MoE), mamba2-2.7b (Mamba-2) and
jamba-1.5-large-398b (the hybrid), fp32, 8 × 64 tokens in
2 microbatches, as DTensors over a 2 × 2 (data, model) mesh of CPU gloo
ranks with the port's partition plan, against the same step in one
process; and the single process against the reference's step on the same
``init_lm`` weights (``convert.lm_params_from_numpy``).

Tolerances (the reference's own): the loss within 1e-4 and every updated
parameter within 1e-3. Sharded products sum their terms in another order
(fp32 rounding, ~1e-6 of a loss of ~6); AdamW's first step moves a weight
by lr · sign(g) (lr 3e-4), so a grad near zero whose sign the order flips
moves it by up to 2 · lr = 6e-4. That first step is blind to a grad's
scale (a rank's share of a grad moves a weight as the sum does), so the
grads themselves are held too, through AdamW's first moment (0.1 · g):
within 1e-4 of each leaf's largest, three orders above the summation
order's ~1e-7 and far below a share missing from a sum (a quarter to a
half of it on a 2 × 2 mesh). The port against the reference: the same
two limits, for the same two reasons (the LM's parity tests hold the
losses and grads themselves tighter, ``test_torch_lm.py``)."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models.model_zoo import get_bundle as j_bundle
from repro.models.transformer import init_lm
from repro.training.trainer import lm_train_state as j_state
from repro.training.trainer import make_lm_train_step as j_step
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_numpy, lm_tree_of
from repro_torch.launch import mesh as M
from repro_torch.models.model_zoo import get_bundle
from repro_torch.training.trainer import lm_train_state, make_lm_train_step
from torch_limits import time_limit
from torch_parity import tree_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
B, S, MB, Q_BLOCK = 8, 64, 2, 32
LOSS_TOL, PARAM_TOL, GRAD_TOL = 1e-4, 1e-3, 1e-4


def _setup(arch, tmp):
    jcfg = JC.reduced(JC.get_arch(arch)).replace(dtype="float32")
    key = jax.random.PRNGKey(0)
    params = init_lm(key, jcfg, jnp.float32)
    toks = np.asarray(jax.random.randint(key, (B, S), 0, jcfg.vocab_size),
                      np.int32)
    z = {"params": tree_numpy(params), "tokens": toks,
         "labels": np.roll(toks, -1, 1)}
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(z, f)
    return jcfg, params, z, path


@pytest.mark.parametrize("arch", ["glm4-9b", "olmoe-1b-7b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
@time_limit(240)
def test_sharded_step_equals_single_process(arch, tmp_path):
    jcfg, params, z, path = _setup(arch, str(tmp_path))
    out = os.path.join(str(tmp_path), "out.pkl")
    procs = M.spawn_ranks(
        "torch_sharded_ranks:lm_step",
        dict(arch=arch, inputs=path, out=out, microbatches=MB,
             q_block=Q_BLOCK),
        shape=(2, 2), run_dir=os.path.join(str(tmp_path), "ranks"),
        device="cpu", timeout_s=120, sys_path=[HERE])
    # the single process meanwhile
    cfg = reduced(get_arch(arch)).replace(dtype="float32")
    b = get_bundle(cfg)
    model = lm_params_from_numpy(z["params"], cfg, device="cpu",
                                 dtype=torch.float32)
    step = make_lm_train_step(lambda m, bt: b.loss(m, bt, q_block=Q_BLOCK),
                              num_microbatches=MB, weight_decay=0.0)
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    st, met = step(lm_train_state(model), batch)
    single = {n: p.detach().numpy() for n, p in st.params.named_parameters()}
    single_mu = {n: m.numpy() for n, m in st.opt.mu.items()}
    # the reference's step on the same weights
    jb = j_bundle(jcfg)
    js, jm = jax.jit(j_step(lambda p, bt: jb.loss(p, bt, q_block=Q_BLOCK),
                            num_microbatches=MB, weight_decay=0.0))(
        j_state(params), {k: jnp.asarray(z[k]) for k in ("tokens",
                                                         "labels")})
    rcs = M.wait_ranks(procs, 200)
    assert rcs == [0] * 4, M.rank_logs(os.path.join(str(tmp_path), "ranks"),
                                       4)
    with open(out, "rb") as f:
        sharded = pickle.load(f)
    # some parameter is split over each axis of the mesh
    shards = {p for pl in sharded["placements"].values() for p in pl}
    assert {"S(0)", "S(1)"} <= shards, shards
    assert abs(sharded["loss"] - float(met["loss"])) < LOSS_TOL
    for n, want in single.items():
        d = float(np.max(np.abs(sharded["params"][n] - want)))
        assert d < PARAM_TOL, (n, d)
    # the grads: every share of a sum summed (a leaf replicated over a
    # mesh axis that splits another input of its op gets its grad partial)
    off = {}
    for n, want in single_mu.items():
        d = float(np.max(np.abs(sharded["mu"][n] - want)))
        top = float(np.max(np.abs(want)))
        if d > GRAD_TOL * top:
            off[n] = (d, top)
    assert not off, off
    assert abs(float(met["loss"]) - float(jm["loss"])) < LOSS_TOL
    ref = lm_tree_of(dict(st.params.named_parameters()), cfg)
    for (pa, a), (pb, c) in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0],
            jax.tree_util.tree_flatten_with_path(tree_numpy(js.params))[0]):
        assert pa == pb
        d = float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(c, np.float32))))
        assert d < PARAM_TOL, (pa, d)
