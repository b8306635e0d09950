"""The port's LM configs, shapes and bundles against the JAX package's: the
ten assigned configs field for field, the parameter counts, the shape
cells and ``input_specs`` (the port's tensors on the ``meta`` device)."""
import dataclasses

import jax
import pytest

import repro.configs as JC
import repro_torch.configs as PC
from repro.models.model_zoo import get_bundle as j_bundle
from repro_torch.convert import lm_cache_to_numpy
from repro_torch.models.model_zoo import LMBundle, get_bundle
from repro_torch.models.transformer import period_len
from torch_parity import CPU

ASSIGNED = sorted(JC.ASSIGNED)


def test_registry_matches_reference():
    assert sorted(PC.ASSIGNED) == ASSIGNED
    assert sorted(PC.GR_CONFIGS) == sorted(JC.GR_CONFIGS)
    assert sorted(PC.ARCHS) == sorted(JC.ARCHS)


@pytest.mark.parametrize("name", ASSIGNED)
def test_config_field_for_field(name):
    assert dataclasses.asdict(PC.get_arch(name)) == \
        dataclasses.asdict(JC.get_arch(name))
    assert dataclasses.asdict(PC.reduced(PC.get_arch(name))) == \
        dataclasses.asdict(JC.reduced(JC.get_arch(name)))


@pytest.mark.parametrize("name", sorted(JC.ARCHS))
def test_counts_kinds_and_cells_match(name):
    pc, jc = PC.get_arch(name), JC.get_arch(name)
    for p, j in ((pc, jc), (PC.reduced(pc), JC.reduced(jc))):
        assert PC.count_params(p) == JC.count_params(j)
        assert PC.count_active_params(p) == JC.count_active_params(j)
        assert p.layer_kinds() == j.layer_kinds()
        assert [p.moe_layer(i) for i in range(p.num_layers)] == \
            [j.moe_layer(i) for i in range(j.num_layers)]
        assert (p.attention_free, p.hybrid) == (j.attention_free, j.hybrid)
    got = [(dataclasses.asdict(s), ok, why) for s, ok, why in PC.cells_for(pc)]
    want = [(dataclasses.asdict(s), ok, why)
            for s, ok, why in JC.cells_for(jc)]
    assert got == want


def test_shapes_match():
    for n, s in JC.SHAPES_BY_NAME.items():
        assert dataclasses.asdict(PC.SHAPES_BY_NAME[n]) == \
            dataclasses.asdict(s)
    assert [s.name for s in PC.ALL_SHAPES] == [s.name for s in JC.ALL_SHAPES]


@pytest.mark.parametrize("name", ASSIGNED)
def test_get_bundle_returns_lm_bundle(name):
    b = get_bundle(PC.get_arch(name))
    assert isinstance(b, LMBundle) and b.cfg.name == name


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ASSIGNED)
def test_input_specs_match_reference(name):
    """Every applicable shape: the batch (or the decode inputs) has the
    reference's shapes and dtypes, on the meta device; the per-layer cache
    stacked per period slot is the reference's cache."""
    pc, jc = PC.get_arch(name), JC.get_arch(name)
    pb, jb = get_bundle(pc), j_bundle(jc)
    for (shape, ok, _), (jshape, _, _) in zip(PC.cells_for(pc),
                                              JC.cells_for(jc)):
        if not ok:
            continue
        got, want = pb.input_specs(shape), jb.input_specs(jshape)
        assert sorted(got) == sorted(want)
        if "cache" in got:
            cache = got.pop("cache")
            assert all(t.is_meta for kv in cache.kv.values() for t in kv)
            assert all(t.is_meta for st in cache.ssm.values()
                       for t in st.values())
            # the reference stacks each period slot's layers
            p = period_len(pc)
            jcache = want.pop("cache")
            for s, (k, v) in jcache.kv.items():
                layers = range(s, pc.num_layers, p)
                for j, jt in enumerate((k, v)):
                    ts = [cache.kv[i][j] for i in layers]
                    assert (len(ts), *ts[0].shape) == jt.shape
                    assert str(ts[0].dtype).split(".")[-1] == str(jt.dtype)
            for s, st in jcache.ssm.items():
                layers = range(s, pc.num_layers, p)
                for key, jt in st.items():
                    ts = [cache.ssm[i][key] for i in layers]
                    assert (len(ts), *ts[0].shape) == jt.shape
                    assert str(ts[0].dtype).split(".")[-1] == str(jt.dtype)
        g, w = _flat(got), _flat(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].is_meta
            assert tuple(g[k].shape) == tuple(w[k].shape), (shape.name, k)
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k


def test_cache_layout_round_trip():
    """lm_cache_to_numpy stacks the per-layer cache per period slot, as the
    reference's DecodeCache (jamba: 1 attention + 7 Mamba slots)."""
    cfg = PC.reduced(PC.get_arch("jamba-1.5-large-398b"))
    cache = get_bundle(cfg).init_cache(2, 16, device=CPU)
    out = lm_cache_to_numpy(cache, cfg)
    jc = j_bundle(JC.reduced(JC.get_arch("jamba-1.5-large-398b"))) \
        .init_cache(2, 16)
    assert sorted(out["kv"]) == sorted(jc.kv)
    assert sorted(out["ssm"]) == sorted(jc.ssm)
    for s in jc.kv:
        assert out["kv"][s][0].shape == jc.kv[s][0].shape
    for s in jc.ssm:
        for k in jc.ssm[s]:
            assert out["ssm"][s][k].shape == jc.ssm[s][k].shape


def test_cli_refuses_lm_archs():
    """The training CLI drives GR models and refuses an LM arch, as the
    reference's does."""
    from repro_torch.launch import train as cli
    with pytest.raises(SystemExit, match="GR models"):
        cli.main(["--device", "cpu", "--arch", "starcoder2-3b"])
