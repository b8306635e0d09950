"""Rank entries of the sparse-parallelism tests (``test_torch_hsp*.py``,
``test_torch_elastic.py``). Each runs in a rank process of its own, started
by ``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo; it reads
its inputs from a pickle the test wrote (numpy only) and writes its
results to another. No jax here: the rank processes import the port
only."""
import pickle

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import gr_params_from_numpy
from repro_torch.core.hsp import adagrad_update, make_hsp_lookup
from repro_torch.models.model_zoo import GRBundle
from repro_torch.training import (GREngine, gr_train_state, make_gr_step_fn,
                                  state_tensors, to_device)
from repro_torch.training.engine import rank_pack

CPU = torch.device("cpu")
MESHES = {"hsp": (("model",), ("data",)), "global": (("data", "model"), ())}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(path, rank, obj):
    with open(path.format(rank=rank), "wb") as f:
        pickle.dump(obj, f)


def _np(t):
    return t.detach().float().cpu().numpy()


def _my_rows(a, mesh):
    """The rows of a (G, ...) array this rank's pack holds (G / world
    each, in rank order, as the reference shards P(("data", "model")))."""
    per = a.shape[0] // mesh.world
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def lookup_cases(mesh, *, inputs, out, arms=("hsp",)):
    """The lookup forward (fp32 and bf16, ids < 0 and ≥ V too), its
    backward of sum(sin(emb)), each grad wire dtype, and four Eq.-1
    AdaGrad steps of mean((emb − target)²), for each arm (``hsp``: the
    table over ``model``; ``global``: over both axes)."""
    z = _load(inputs)
    table = z["table"]
    V, d = table.shape
    res = {}
    for arm in arms:
        ga, da = MESHES[arm]
        res[arm] = r = {}
        hsp = make_hsp_lookup(mesh, group_axes=ga, dp_axes=da,
                              compute_dtype=torch.float32)
        lo, hi = hsp.shard_range(V)
        r["lo"] = lo
        ids = torch.from_numpy(_my_rows(z["ids"], mesh))
        shard = torch.tensor(table[lo:hi], requires_grad=True)
        emb = hsp(shard, ids)
        torch.sin(emb).sum().backward()
        r["emb"], r["grad"] = _np(emb), _np(shard.grad)
        odd = torch.from_numpy(_my_rows(z["odd_ids"], mesh))
        r["odd_fp32"] = _np(hsp.gather(shard.detach(), odd))
        r["odd_bf16"] = hsp.gather(shard.detach(), odd,
                                   torch.bfloat16).float().numpy()
        r["wire"] = {}
        for name, w in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16), ("int8", torch.int8)):
            lk = make_hsp_lookup(mesh, group_axes=ga, dp_axes=da,
                                 compute_dtype=torch.float32,
                                 grad_wire_dtype=w)
            s = torch.tensor(table[lo:hi], requires_grad=True)
            torch.sin(lk(s, ids)).sum().backward()
            r["wire"][name] = _np(s.grad)
        lk = make_hsp_lookup(mesh, group_axes=ga, dp_axes=da,
                             compute_dtype=torch.float32,
                             unique_capacity=z["cap"])
        s = torch.tensor(table[lo:hi], requires_grad=True)
        torch.sin(lk(s, ids)).sum().backward()
        r["capped"] = _np(s.grad)
        elo, ehi = hsp.shard_range(z["eq1_table"].shape[0])
        r["eq1_lo"] = elo
        w_ = torch.tensor(z["eq1_table"][elo:ehi])
        acc = torch.zeros_like(w_)
        for t in range(len(z["eq1_ids"])):
            ids_t = torch.from_numpy(_my_rows(z["eq1_ids"][t], mesh))
            tgt = torch.from_numpy(_my_rows(z["eq1_tgt"][t], mesh))
            leaf = w_.clone().requires_grad_()
            e = hsp(leaf, ids_t)
            loss = ((e - tgt) ** 2).sum() / z["eq1_tgt"][t].size
            g, = torch.autograd.grad(loss, leaf)
            w_, acc = adagrad_update(w_, acc, g, z["lr"])
        r["eq1_master"], r["eq1_accum"] = _np(w_), _np(acc)
        r["stats"] = {k: dict(v) for k, v in mesh.stats.items()}
        mesh.stats.clear()
    _dump(out, mesh.rank, res)


def _port_cfg(z):
    return reduced(get_arch(z["arch"])).replace(**z["overrides"])


def _shard_state(z, cfg, hsp):
    model = gr_params_from_numpy(z["dense"], cfg, device=CPU)
    lo, hi = hsp.shard_range(z["master"].shape[0])
    master = torch.tensor(z["master"][lo:hi])      # a copy: trained in place
    return gr_train_state(model, master, qdtype=None)


def _shard_dump(st, hsp):
    lo, _ = hsp.shard_range(hsp.vocab_of(st.table.master))
    return dict(lo=lo, dense={n: _np(p) for n, p in
                              st.dense.named_parameters()},
                mu={k: _np(v) for k, v in st.dense_opt.mu.items()},
                nu={k: _np(v) for k, v in st.dense_opt.nu.items()},
                count=st.dense_opt.count, master=_np(st.table.master),
                accum=_np(st.table.accum),
                pending_ids=st.pending_ids.numpy(),
                pending_rows=_np(st.pending_rows))


def _flat_run(b, hsp, z, cfg, batches, lk):
    """N sync then N τ=1 flat steps from the test's init: (losses, the
    final state)."""
    st = _shard_state(z, cfg, hsp)
    losses = []
    for i, bt in enumerate(batches[:2 * z["n"]]):
        if i in (0, z["n"]):
            step = make_gr_step_fn(b, loss_kwargs=lk, semi_async=i >= z["n"],
                                   hsp=hsp)
        st, m = step(st, to_device(bt, CPU))
        losses.append(float(m["loss"]))
    return losses, st


def _engine_vs_flat(b, hsp, z, cfg, batches, global_batches, lk):
    """GREngine in both schedules (τ=1, ``engine_steps`` steps), each
    against the flat τ=1 step bit for bit."""
    step = make_gr_step_fn(b, loss_kwargs=lk, semi_async=True, hsp=hsp)
    ref = _shard_state(z, cfg, hsp)
    ref_losses = []
    for bt in batches[:z["engine_steps"]]:
        ref, m = step(ref, to_device(bt, CPU))
        ref_losses.append(float(m["loss"]))
    res = {"losses": ref_losses}
    for sched in ("algorithm1", "flat"):
        eng = GREngine(b, lambda i: global_batches[i], state=_shard_state(
            z, cfg, hsp), loss_kwargs=lk, schedule=sched, hsp=hsp)
        got = [r["loss"] for r in eng.run(z["engine_steps"])]
        same = got == ref_losses and all(
            torch.equal(x, y) for x, y in zip(state_tensors(eng.state),
                                              state_tensors(ref)))
        res[sched] = dict(losses=got, bitwise=same)
    return res


def engine_cases(mesh, *, inputs, out):
    """N sync then N τ=1 flat steps over a sharded table from the test's
    init; GREngine in both schedules (τ=1, ``engine_steps`` steps), each
    equal bit for bit to the flat τ=1 step. Then, for each segment of
    ``z["share"]``, the same at ``expansion`` 2 (the pool shared across
    ranks): the flat steps on batches that carry the test's perms
    (``share_perms``), with each exchange's bytes; the engine on perms the
    loss draws itself."""
    z = _load(inputs)
    cfg = _port_cfg(z)
    b = GRBundle(cfg)
    batches = [rank_pack(bt, mesh.rank) for bt in z["batches"]]
    hsp = make_hsp_lookup(mesh, compute_dtype=torch.float32)
    lk = z["loss_kwargs"]
    losses, st = _flat_run(b, hsp, z, cfg, batches, lk)
    res = dict(rank=mesh.rank,
               flat=dict(losses=losses, state=_shard_dump(st, hsp)))
    res["engine"] = _engine_vs_flat(b, hsp, z, cfg, batches, z["batches"],
                                    lk)
    res["share"] = {}
    for seg, perms in z["share"].items():
        slk = dict(lk, neg_segment=seg, expansion=2)
        given = [rank_pack(dict(bt, share_perms=p), mesh.rank)
                 for bt, p in zip(z["batches"], perms)]
        mesh.stats.clear()
        losses, st = _flat_run(b, hsp, z, cfg, given, slk)
        stats = {k: dict(v) for k, v in mesh.stats.items()
                 if k.startswith("share_")}
        res["share"][seg] = dict(
            flat=dict(losses=losses, state=_shard_dump(st, hsp)),
            stats=stats,
            engine=_engine_vs_flat(b, hsp, z, cfg, batches, z["batches"],
                                   slk))
    res["checks"] = dict(hsp.checks)
    _dump(out, mesh.rank, res)


def save_and_dump(mesh, *, inputs, out, ckpt_dir, steps):
    """``steps`` τ=1 engine steps from the test's init over a sharded
    table with a save after the last; this rank's state then (the
    carry-convention state the save holds)."""
    z = _load(inputs)
    cfg = _port_cfg(z)
    hsp = make_hsp_lookup(mesh, compute_dtype=torch.float32)
    eng = GREngine(GRBundle(cfg), lambda i: z["batches"][i],
                   state=_shard_state(z, cfg, hsp),
                   loss_kwargs=z["loss_kwargs"], hsp=hsp)
    eng.run_resilient(steps, ckpt_dir=ckpt_dir, ckpt_every=steps)
    _dump(out, mesh.rank, _shard_dump(eng.state, hsp))


def card_lookup(mesh, *, V, d, n, seed):
    """On the card: the 2-rank lookup's forward (bf16 and fp32) against a
    torch gather of the full table, bit for bit, and its backward of
    sum(emb · w) against ``index_add_`` (fp32 sums in another order:
    1e-5 of the largest grad)."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(V, d, generator=g).to(mesh.device)
    ids = torch.randint(0, V, (mesh.world, n), generator=g)
    w = torch.randn(mesh.world, n, d, generator=g)
    hsp = make_hsp_lookup(mesh, compute_dtype=torch.float32)
    lo, hi = hsp.shard_range(V)
    mine = ids[mesh.rank].to(mesh.device)
    shard = table[lo:hi].clone().requires_grad_()
    emb = hsp(shard, mine)
    fwd = torch.equal(emb, table[mine.long()])
    bf = torch.equal(hsp.gather(shard.detach(), mine, torch.bfloat16),
                     table[mine.long()].bfloat16())
    (emb * w[mesh.rank].to(mesh.device)).sum().backward()
    want = torch.zeros_like(table).index_add_(
        0, ids.reshape(-1).long().to(mesh.device),
        w.reshape(-1, d).to(mesh.device))[lo:hi]
    err = float((shard.grad - want).abs().max() / want.abs().max())
    return dict(fwd=fwd, bf16=bf, grad_rel=err, on=str(emb.device))


def card_world1(mesh, *, V, layers, upd, steps, loss_kwargs=None):
    """On the card: a world of one against the single-process engine,
    hstu-large widths at ``layers`` layers, bit for bit (losses and every
    state tensor); ``loss_kwargs`` bound into both losses."""
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    cfg = get_arch("hstu-large").replace(vocab_size=V, num_layers=layers)
    gen = SyntheticKuaiRand(num_users=16, num_items=V, mean_len=400,
                            max_len=1024, seed=0)
    seqs = {u: (s["item"], s["ts"]) for u, s in
            ((u, gen.interactions(u)) for u in range(16))}
    batches = list(GRLoader(seqs, num_devices=1, users_per_device=upd,
                            max_seq_len=512, num_negatives=128, num_items=V,
                            seed=0).batches(steps))
    hsp = make_hsp_lookup(mesh, compute_dtype=torch.bfloat16)
    a = GREngine(GRBundle(cfg), lambda i: batches[i], seed=0, hsp=hsp,
                 loss_kwargs=loss_kwargs)
    la = [r["loss"] for r in a.run(steps)]
    b = GREngine(GRBundle(cfg), lambda i: batches[i], seed=0,
                 device=mesh.device, loss_kwargs=loss_kwargs)
    lb = [r["loss"] for r in b.run(steps)]
    same = all(torch.equal(x, y) for x, y in zip(state_tensors(a.state),
                                                 state_tensors(b.state)))
    return dict(losses=la, single=lb, bitwise=la == lb and same)
