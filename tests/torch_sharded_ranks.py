"""Rank entry of ``test_torch_sharded_parity.py``: one LM train step as
DTensors over a (data, model) ``DeviceMesh`` of CPU gloo ranks, with the
port's partition plan (``launch/partition.py``). It reads the weights and
the batch from a pickle the test wrote (numpy only) and writes the loss
and every updated parameter, gathered whole, from rank 0. No jax here:
the rank processes import the port only."""
import dataclasses
import pickle

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.dryrun import _sharded
from repro_torch.launch import mesh as M
from repro_torch.launch import partition as PT
from repro_torch.models.model_zoo import get_bundle
from repro_torch.training.trainer import lm_train_state, make_lm_train_step


def lm_step(mesh, *, arch, inputs, out, microbatches, q_block):
    with open(inputs, "rb") as f:
        z = pickle.load(f)
    cfg = reduced(get_arch(arch)).replace(dtype="float32")
    b = get_bundle(cfg)
    model = lm_params_from_numpy(z["params"], cfg, device="cpu",
                                 dtype=torch.float32)
    dm = M.device_mesh(mesh.shape, mesh.axes, device="cpu")
    B, S = z["tokens"].shape
    plan = PT.make_plan(cfg, ShapeConfig("t", S, B, "train"), dm)
    plan = dataclasses.replace(plan, num_microbatches=microbatches)
    PT.shard_model(model, dm, plan)
    from torch.distributed.tensor import distribute_tensor
    bspec = PT.to_placements(dm, (plan.rules["batch"], None))
    batch = {k: distribute_tensor(torch.from_numpy(z[k]), dm, bspec)
             for k in ("tokens", "labels")}
    step = make_lm_train_step(
        lambda m, bt: b.loss(m, bt, q_block=q_block),
        num_microbatches=plan.num_microbatches, weight_decay=0.0)
    state = lm_train_state(model)
    with _sharded(dm, plan):
        state, met = step(state, batch)
    loss = float(met["loss"].full_tensor())
    params = {n: p.detach().full_tensor().numpy()
              for n, p in state.params.named_parameters()}
    mu = {n: m.full_tensor().numpy() for n, m in state.opt.mu.items()}
    placements = {n: [str(x) for x in p.placements]
                  for n, p in state.params.named_parameters()}
    if mesh.rank == 0:
        with open(out, "wb") as f:
            pickle.dump({"loss": loss, "params": params, "mu": mu,
                         "placements": placements}, f)
    return {"loss": loss}
