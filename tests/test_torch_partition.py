"""The port's partition plans (``launch/partition.py``) against the JAX
package's, on both production meshes: ``make_plan`` field by field for
every runnable cell, and every LM parameter's spec (and so its DTensor
placements) against its reference leaf's ``PartitionSpec`` (the port's
per-layer parameter against the reference's leaf stacked over the
periods, the stacked axis dropped); the GR, batch and cache specs. The
reference plans on ``jax.sharding.AbstractMesh`` (no devices), the port on
its ``AbstractMesh``; ``make_production_mesh`` builds real
``DeviceMesh`` es over a fake world in a subprocess (the fake process group
would outlive the test in the worker). Exact equality throughout: these
are integer and string computations."""
import dataclasses
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

import repro.configs as JC
import repro_torch.configs as PC
from repro.configs.shapes import SHAPES_BY_NAME as JS
from repro.launch import partition as JPT
from repro.models.model_zoo import get_bundle as j_bundle
from repro_torch.convert import _lm_key
from repro_torch.launch import partition as PT
from repro_torch.launch.dryrun_all import list_cells
from repro_torch.models.model_zoo import get_bundle
from repro_torch.models.transformer import period_len
from torch_limits import time_limit

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = list_cells()[0]


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), PT.AbstractMesh(shape, axes)


def _spec(p):
    """A spec as a tuple, one entry a dim, an entry of one axis as its
    name (``PartitionSpec`` writes ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(p))


@time_limit(30)
def test_cells_are_the_references():
    from repro.configs.shapes import cells_for as j_cells_for
    want = [(n, s.name) for n, c in JC.ARCHS.items()
            for s, ok, _ in j_cells_for(c) if ok]
    assert sorted(CELLS) == sorted(want) and len(CELLS) == 60


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
@time_limit(30)
def test_make_plan_matches_reference(arch, shape, mesh_name):
    jm, pm = meshes(mesh_name)
    want = JPT.make_plan(JC.get_arch(arch), JS[shape], jm)
    got = PT.make_plan(PC.get_arch(arch), PC.SHAPES_BY_NAME[shape], pm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@time_limit(30)
def test_plan_overrides_env(monkeypatch):
    jm, pm = meshes("pod16x16")
    raw = '{"num_microbatches": 2, "nonsense": 1}'
    monkeypatch.setenv(PT.OVERRIDES_ENV, raw)
    monkeypatch.setenv("REPRO_PLAN_OVERRIDES", raw)
    got = PT.make_plan(PC.get_arch("glm4-9b"), PC.SHAPES_BY_NAME["train_4k"],
                       pm)
    want = JPT.make_plan(JC.get_arch("glm4-9b"), JS["train_4k"], jm)
    assert got.num_microbatches == 2 and "overrides=" in got.notes
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


LM_CASES = [(a, s, m) for a in sorted(JC.ASSIGNED)
            for s in ("train_4k", "decode_32k") for m in sorted(MESHES)]


@pytest.mark.parametrize("arch,shape,mesh_name", LM_CASES)
@time_limit(60)
def test_lm_param_specs_match_reference(arch, shape, mesh_name):
    """Every port parameter's spec is its reference leaf's, the stacked
    axis dropped, and so are its placements."""
    jm, pm = meshes(mesh_name)
    jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
    jplan = JPT.make_plan(jcfg, JS[shape], jm)
    pplan = PT.make_plan(pcfg, PC.SHAPES_BY_NAME[shape], pm)
    params = jax.eval_shape(j_bundle(jcfg).init, jax.random.PRNGKey(0))
    jspecs = JPT.lm_param_specs(params, jm, jplan)
    model = get_bundle(pcfg).init(device="meta")
    got = PT.lm_param_specs(model, pm, pplan)
    p = period_len(pcfg)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path, per = _lm_key(name, p)
        node = jspecs
        for k in path:
            node = node[k]
        want = _spec(node)
        if per is not None:
            assert want[0] is None, name
            want = want[1:]
        assert _spec(spec) == _spec(want), (name, spec, want)
        assert (PT.to_placements(pm, spec)
                == PT.to_placements(pm, want)), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["hstu-large", "fuxi-large",
                                  "sasrec-large"])
@time_limit(60)
def test_gr_specs_match_reference(arch, mesh_name):
    from repro.training.trainer import gr_pending_slots as j_pend
    jm, pm = meshes(mesh_name)
    jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
    shape = "gr_train_2k"
    jplan = JPT.make_plan(jcfg, JS[shape], jm)
    pplan = PT.make_plan(pcfg, PC.SHAPES_BY_NAME[shape], pm)
    assert PT.gr_table_spec(pm, pplan) == _spec(JPT.gr_table_spec(jm,
                                                                  jplan))
    n_shards = 256 if mesh_name == "pod16x16" else 512
    jin = j_bundle(jcfg).input_specs(JS[shape], num_shards=n_shards)
    pin = get_bundle(pcfg).input_specs(PC.SHAPES_BY_NAME[shape],
                                       num_shards=n_shards)
    assert {k: tuple(v.shape) for k, v in jin["batch"].items()} == \
        {k: tuple(v.shape) for k, v in pin["batch"].items()}
    n_pend = j_pend(jin["batch"])
    assert _spec(PT.gr_pend_spec(pm, n_pend)) == _spec(JPT.gr_pend_spec(
        jm, n_pend))
    jb = JPT.batch_specs(jcfg, JS[shape], jm, jplan, jin)["batch"]
    pb = PT.batch_specs(pcfg, PC.SHAPES_BY_NAME[shape], pm, pplan,
                        pin)["batch"]
    assert {k: _spec(v) for k, v in jb.items()} == {
        k: _spec(v) for k, v in pb.items()}
    dense = get_bundle(pcfg).init_dense(device="meta")
    assert all(s == (None,) * t.dim() for s, t in zip(
        PT.gr_param_specs(dense, pm, pplan).values(), dense.parameters()))
    kv = (pcfg.num_layers, pcfg.num_heads, pcfg.qkv_dim or
          pcfg.resolved_head_dim, pcfg.qkv_dim or pcfg.resolved_head_dim)
    kw = dict(max_users=63, max_seq_len=pcfg.max_seq_len,
              d_model=pcfg.d_model, kv_shape=kv, vocab=pcfg.vocab_size)
    assert {k: _spec(v) for k, v in PT.gr_serve_specs(pm, **kw).items()} \
        == {k: _spec(v) for k, v in JPT.gr_serve_specs(jm, **kw).items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", [
    ("starcoder2-3b", "decode_32k"), ("mamba2-2.7b", "long_500k"),
    ("jamba-1.5-large-398b", "long_500k"), ("glm4-9b", "decode_32k")])
@time_limit(60)
def test_decode_input_specs_match_reference(arch, shape, mesh_name):
    """The decode inputs' specs: the token, the index and each layer's
    cache entry against the reference's stacked leaf."""
    jm, pm = meshes(mesh_name)
    jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
    jplan = JPT.make_plan(jcfg, JS[shape], jm)
    pplan = PT.make_plan(pcfg, PC.SHAPES_BY_NAME[shape], pm)
    jin = j_bundle(jcfg).input_specs(JS[shape])
    pin = get_bundle(pcfg).input_specs(PC.SHAPES_BY_NAME[shape])
    js = JPT.batch_specs(jcfg, JS[shape], jm, jplan, jin)
    ps = PT.batch_specs(pcfg, PC.SHAPES_BY_NAME[shape], pm, pplan, pin)
    assert ps["token"] == _spec(js["token"])
    assert ps["cache_index"] == _spec(js["cache_index"])
    p = period_len(pcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        js["cache"], is_leaf=lambda x: isinstance(x, P))[0]
    jcache = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): _spec(v) for path, v in flat}
    n = 0
    for i, kv in ps["cache"]["kv"].items():
        for j, spec in enumerate(kv):
            key = [k for k in jcache if str(i % p) in k
                   and k[-1] in (("k", "v")[j], str(j))]
            assert any(jcache[k][1:] == spec for k in key), (i, j, spec)
            n += 1
    for i, st in ps["cache"]["ssm"].items():
        for name, spec in st.items():
            key = [k for k in jcache if str(i % p) in k and k[-1] == name]
            assert key and all(jcache[k][1:] == spec for k in key), \
                (i, name, spec, key)
            n += 1
    assert n > 0


MESH_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import mesh as M
try:
    M.make_production_mesh(device="cpu")
except RuntimeError as e:
    assert "init_fake_world(256)" in str(e), e
else:
    raise AssertionError("no process group, no mesh")
M.init_fake_world(512)
one = M.make_production_mesh(device="cpu")
two = M.make_production_mesh(multi_pod=True, device="cpu")
assert tuple(one.shape) == (16, 16) and one.mesh_dim_names == ("data", "model")
assert tuple(two.shape) == (2, 16, 16)
assert two.mesh_dim_names == ("pod", "data", "model")
from repro_torch.launch import partition as PT
from repro_torch.configs import get_arch, SHAPES_BY_NAME
for m in (one, two):
    am = PT.AbstractMesh(tuple(m.shape), m.mesh_dim_names)
    for a, s in (("glm4-9b", "train_4k"), ("hstu-large", "gr_train_2k"),
                 ("mamba2-2.7b", "long_500k")):
        assert PT.make_plan(get_arch(a), SHAPES_BY_NAME[s], m) == \
            PT.make_plan(get_arch(a), SHAPES_BY_NAME[s], am)
print("ok")
"""


@time_limit(90)
def test_make_production_mesh_over_a_fake_world():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT, src],
                       capture_output=True, text=True, timeout=80)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout + r.stderr
