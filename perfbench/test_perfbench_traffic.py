"""The traffic generator repeats from a seed and gives every seed the
same work."""
import numpy as np

from perfbench import tiny
from perfbench.traffic import gen

BIG = 2 ** 31 + 12345


def test_train_batch_repeats_from_the_seed():
    mix = tiny.mix("train_long")
    a = gen.train_batch(mix, BIG, 3, 4096, 8)
    b = gen.train_batch(mix, BIG, 3, 4096, 8)
    c = gen.train_batch(mix, BIG + 1, 3, 4096, 8)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["ids"], c["ids"])


def test_every_seed_and_step_packs_the_same_lengths():
    mix = tiny.mix("train_short")
    tot = {int(gen.train_batch(mix, s, i, 4096, 8)["offsets"][0, -1])
           for s in (1, 2, BIG) for i in (0, 5)}
    assert len(tot) == 1
    lens = sorted(np.diff(gen.train_batch(mix, 7, 0, 4096, 8)["offsets"][0]))
    assert sorted(n - 1 for n in gen.pack_lengths(mix)) == \
        [x for x in lens if x > 0]


def test_strata_follow_the_lognormal():
    lens = gen.strata_lengths(5.5, 1.3, 2049, 8)
    assert lens == sorted(lens) and lens[-1] <= 2049
    # the stratum means average to the capped distribution's mean (~480)
    assert 430 < np.mean(lens) < 530


def test_arrivals_repeat_and_keep_the_work():
    mix = dict(tiny.mix("serve_open"), rate_per_s=50.0)
    t1, k1, l1 = gen.arrivals(mix, BIG, 4.0)
    t2, k2, l2 = gen.arrivals(mix, BIG, 4.0)
    t3, k3, l3 = gen.arrivals(mix, 3, 4.0)
    assert np.array_equal(t1, t2) and k1 == k2 and l1 == l2
    assert not np.array_equal(t1, t3)
    assert sorted(k1) == sorted(k3) and sorted(l1) == sorted(l3)
    assert np.isclose(t1[-1], t3[-1])
    assert len(t1) == 200 and np.all(np.diff(t1) > 0)


def test_items_stay_in_the_vocabulary():
    rng = gen.rng_for(BIG, 1)
    ids = gen.zipf_items(rng, 10000, 4096, 1.1)
    assert ids.min() >= 0 and ids.max() < 4096
    # Zipf: the most popular item is far above uniform
    assert np.bincount(ids).max() > 50 * 10000 / 4096


def test_prefetched_feed_hands_over_the_same_batches():
    from perfbench import train
    prog = train.Program.__new__(train.Program)
    prog.mix, prog.seed, prog.fault = tiny.mix("train_short"), BIG, None
    prog.cfgj = {"vocab_size": 4096, "num_negatives": 8}
    prog.base, prog.ready = 5, {}
    prog.prefetch(3)
    assert sorted(prog.ready) == [5, 6, 7]
    for j in (0, 1, 2, 3):      # 3 was not prefetched: made on demand
        b, want = prog.batch(j), gen.train_batch(prog.mix, BIG, 5 + j,
                                                 4096, 8)
        for k in want:
            assert np.array_equal(b[k], want[k]), (j, k)
    assert prog.ready == {}
