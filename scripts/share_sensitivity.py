#!/usr/bin/env python3
"""How far logit sharing across HSP ranks (expansion 2) lies from the
reference and from the port's single process on the CPU test batches of
``tests/test_torch_hsp_engine.py``, beside how far a one-ulp change of the
init moves the port's own single process (CPU, fp32; gloo rank processes
for the ranks). For each world and segment: the port's single process and
the ranks against the reference trainer (the reference's perms injected),
the ranks against the single process, the single process against itself
with one table row moved by an ulp, and the first step's table grads of
the port against ``jax.grad`` of the reference's loss.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/share_sensitivity.py \
        --worlds 2 --segments 128
"""
import argparse
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import test_torch_hsp_engine as H                       # noqa: E402
from repro_torch.convert import (adamw_to_numpy,        # noqa: E402
                                 gr_params_from_numpy)
from repro_torch.models.model_zoo import GRBundle       # noqa: E402
from repro_torch.training import AdamWState, to_device  # noqa: E402
from torch_parity import tree_numpy                     # noqa: E402


FIELDS = ("loss", "dense", "mu", "nu", "master", "accum", "rows")


def port_fields(w, losses, dense, opt, master, accum, rows):
    """A port run's compared fields, the dense params and moments as the
    reference's tree leaves, the carry's rows as ascending ids."""
    return dict(loss=[np.asarray(losses)],
                dense=jax.tree_util.tree_leaves(H._tree(w, dense)),
                mu=jax.tree_util.tree_leaves(opt["mu"]),
                nu=jax.tree_util.tree_leaves(opt["nu"]),
                master=[master], accum=[accum], rows=[rows])


def single_fields(w, st, losses):
    return port_fields(
        w, losses, {n: p.detach().numpy()
                    for n, p in st.dense.named_parameters()},
        adamw_to_numpy(st.dense_opt), st.table.master.numpy(),
        st.table.accum.numpy(), st.pending_rows.detach().numpy())


def ranks_fields(w, world, flats):
    got = H._full([f["state"] for f in flats], world)
    opt = adamw_to_numpy(AdamWState(
        *({n: torch.from_numpy(v) for n, v in got[k].items()}
          for k in ("mu", "nu")), got["count"]))
    return port_fields(w, flats[0]["losses"], got["dense"], opt,
                       got["master"], got["accum"], got["pending_rows"])


def reference_fields(js, losses):
    jids = np.asarray(js.pending_ids)
    keep = jids >= 0
    order = np.argsort(jids[keep], kind="stable")
    return dict(loss=[np.asarray(losses)],
                dense=jax.tree_util.tree_leaves(tree_numpy(js.dense)),
                mu=jax.tree_util.tree_leaves(tree_numpy(js.dense_opt.mu)),
                nu=jax.tree_util.tree_leaves(tree_numpy(js.dense_opt.nu)),
                master=[np.asarray(js.table.master)],
                accum=[np.asarray(js.table.accum)],
                rows=[np.asarray(js.pending_rows)[keep][order]])


def gaps(name, got, want):
    """Each field's largest difference and, of its leaves, the most
    elements over the fp32 limit ``H.TOL`` (the count a ``Tol`` bounds)."""
    parts = []
    for k in FIELDS:
        d = [np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
             for a, b in zip(got[k], want[k])]
        lim = H.TOL[k].atol if isinstance(H.TOL[k], H.Tol) else H.TOL[k]
        parts.append(f"{k} {max(float(x.max()) for x in d):.3g}"
                     f"/{max(int((x > lim).sum()) for x in d)}")
    print(f"  {name}: " + ", ".join(parts))


def first_grads(w, seg):
    """The first batch's table grad: the port's loss (dense grad at test
    size) against jax.grad of the reference's, max diff over the largest."""
    z, cp = w["z"], w["cp"]
    jb = H.j_bundle(w["cj"])
    batch = z["batches"][0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "weights"}
    jg = np.asarray(jax.grad(lambda t: jb.loss(
        w["dense"], t, jbatch, neg_mode="fused", neg_segment=seg,
        expansion=2, fetch_dtype=None))(jnp.asarray(w["table"])))
    t = torch.from_numpy(w["table"].copy()).requires_grad_()
    GRBundle(cp).loss(
        gr_params_from_numpy(z["dense"], cp, device="cpu"), t,
        to_device(dict(batch, share_perms=z["share"][seg][0]), "cpu"),
        neg_segment=seg, expansion=2, fetch_dtype=None).backward()
    return float(np.abs(t.grad.numpy() - jg).max() / np.abs(jg).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--segments", type=int, nargs="+",
                    default=list(H.SHARE_SEGMENTS))
    args = ap.parse_args()
    torch.set_num_threads(1)
    for world in args.worlds:
        with tempfile.TemporaryDirectory() as tmp:
            w = H._collect(*H._start(tmp, world))
        for seg in args.segments:
            print(f"world {world}, segment {seg}, expansion 2, "
                  f"{2 * H.N} steps:")
            js, jl = H._reference(w, seg, 2)
            ref = reference_fields(js, jl)
            st, sl = H._single(w, seg=seg)
            single = single_fields(w, st, sl)
            ranks = ranks_fields(
                w, world, [r["share"][seg]["flat"] for r in w["res"]])
            gaps("single vs reference", single, ref)
            gaps("ranks vs reference", ranks, ref)
            gaps("ranks vs single", ranks, single)
            # one ulp up on every element of the first label's table row
            moved = dict(w, table=w["table"].copy())
            row = int(w["z"]["batches"][0]["labels"][0, 0])
            moved["table"][row] = np.nextafter(moved["table"][row],
                                               np.float32(1))
            gaps(f"single, one ulp of table row {row}, vs single",
                 single_fields(moved, *H._single(moved, seg=seg)), single)
            print(f"  first step's table grads, port vs reference: "
                  f"{first_grads(w, seg):.3g} of the largest")


if __name__ == "__main__":
    main()
