"""Random open-loop traffic for the port's ``StreamingRecallEngine``, and
the check that every user a tick encoded holds the bits of a cold encode
of its history. Imports no jax: ``tests/test_torch_serving_stream.py``
drives it on the CPU (the kernels' plain versions) and
``tests/test_torch_gpu.py`` on the card.

The traffic is that of a client holding each user's full history: new
users with lognormal histories, pure hits, 1-3-event appends, bursts of
three appends to one user, and a full resend after ``resend_full`` (the
user was evicted); a user shed while not resident is given up."""
import numpy as np
import torch

from repro_torch.embedding.tables import lookup
from repro_torch.models import gr as GR

KINDS = ("new", "hit", "append", "burst")


def cold_encode(eng, slots):
    """From-scratch cold encodes of the given slots' host histories, into
    caches of their own: emb (n, d), k, v (L, n, cap, H, D), lengths."""
    b, cfg = eng.buffer, eng.cfg
    dev, S, n = b.device, b.max_seq_len, len(slots)
    ids = np.zeros((n, S), np.int32)
    ts = np.zeros((n, S), np.int32)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(slots):
        m = int(b.length[s])
        ids[i, :m], ts[i, :m], lens[i] = b.h_ids[s, :m], b.h_ts[s, :m], m
    k = torch.zeros((cfg.num_layers, n) + tuple(b.kv_k.shape[2:]),
                    dtype=b.kv_k.dtype, device=dev)
    v = torch.zeros_like(k)
    x = lookup(eng.table.master, torch.from_numpy(ids).to(dev),
               dtype=GR.torch_dtype(cfg.dtype))
    emb = GR.gr_encode_slots(eng.model, cfg, x, torch.from_numpy(ts).to(dev),
                             torch.from_numpy(lens).to(dev), k, v,
                             torch.arange(n, device=dev, dtype=torch.int32))
    return emb, k, v, lens


def mismatches(eng, slots):
    """(user, length) of every given slot whose device embedding row or
    live K/V of any layer differs from a cold encode, bit for bit."""
    b = eng.buffer
    emb, k, v, lens = cold_encode(eng, slots)
    bad = []
    for i, s in enumerate(slots):
        m = int(lens[i])
        if not (torch.equal(b.emb[s], emb[i])
                and torch.equal(b.kv_k[:, s, :m], k[:, i, :m])
                and torch.equal(b.kv_v[:, s, :m], v[:, i, :m])):
            bad.append((int(b.user[s]), m))
    return bad


def drive(eng, rng, ticks, *, mix=(0.1, 0.3, 0.5, 0.1), submits=(1, 12),
          new_len=(4.5, 1.0)):
    """``ticks`` rounds of a random number of submits (``submits`` range)
    in the proportions ``mix`` of :data:`KINDS`, each round ending in one
    tick, after which every slot the tick encoded is held to a cold
    encode. Returns the counts {rows checked, warm rows, cold rows,
    evictions, full resends, checked rows longer than 128 and than 256};
    raises AssertionError on the first mismatch."""
    b = eng.buffer
    S, V = b.max_seq_len, eng.cfg.vocab_size
    hist, gone = {}, set()
    checked = resends = over_128 = over_256 = 0

    def events(u, m):
        ids = rng.integers(0, V, m).astype(np.int32)
        t0 = int(hist[u][1][-1]) if u in hist else 0
        return ids, (t0 + np.cumsum(rng.integers(1, 3600, m))).astype(
            np.int32)

    def submit(u, ids, ts):
        nonlocal resends
        a = eng.submit(u, ids, ts)
        if a.accepted or a.outcome == "resend_full":
            hist[u] = (np.concatenate([hist[u][0], ids])[-S:],
                       np.concatenate([hist[u][1], ts])[-S:])
        if a.outcome == "resend_full":
            resends += 1
            a = eng.submit(u, *hist[u])
        if not a.accepted and b.slot_of(u) is None:
            gone.add(u)
        return a

    for _ in range(ticks):
        for _ in range(int(rng.integers(*submits))):
            users = [u for u in hist if u not in gone]
            kind = rng.choice(KINDS, p=np.array(mix) / sum(mix))
            if kind == "new" or not users:
                u = max(hist, default=-1) + 1
                m = int(min(S, max(1, rng.lognormal(*new_len))))
                hist[u] = events(u, m)
                if not eng.submit(u, *hist[u]).accepted:
                    gone.add(u)
                continue
            u = users[int(rng.integers(len(users)))]
            if kind == "hit":
                submit(u, np.zeros(0, np.int32), np.zeros(0, np.int32))
                continue
            for _ in range(3 if kind == "burst" else 1):
                if u not in gone:
                    submit(u, *events(u, int(rng.integers(1, 4))))
        user0, ver0 = b.user.copy(), b.enc_version.copy()
        eng.tick()
        slots = [s for s in range(b.max_users)
                 if b.user[s] >= 0 and b.emb_fresh(s)
                 and (b.user[s] != user0[s] or b.enc_version[s] != ver0[s])]
        if slots:
            bad = mismatches(eng, slots)
            assert not bad, f"warm != cold for (user, length) {bad}"
            checked += len(slots)
            lens = b.length[slots]
            over_128 += int((lens > 128).sum())
            over_256 += int((lens > 256).sum())
    return dict(checked=checked, warm_rows=eng.warm_rows,
                cold_rows=eng.cold_rows, evictions=b.evictions,
                resends=resends, over_128=over_128, over_256=over_256)
