"""The plain reference against the program's CPU path at a tiny size,
and the control (the reference in float8) far from it and failing each
training cell's committed limits.

Tolerances at this size: the program runs its plain versions in bfloat16
with bfloat16 parameters, the reference in float32. The losses of the
three checked steps agree to a 1%; every leaf's first gradient to a tenth
of max(its norm, the median leaf's); the change after three steps to a
third (bfloat16 parameters round AdamW's steps of 4e-3 on unit norm
weights by up to half their size)."""
import pytest
import torch

from perfbench import common, control, serve, tiny, train

CPU = torch.device("cpu")
TOL = {"loss_gap": 0.01, "grad_gap": 0.1, "change_gap": 1 / 3}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["hstu_large", "fuxi_large"])
def test_reference_agrees_with_the_program(config):
    cfg, mix = tiny.config(config), tiny.mix("train_long")
    p = train.Program(cfg, mix, 17, CPU)
    p.checked_run(mix["checked_steps"])
    ref = train.reference_readings(cfg, mix, 17, CPU)
    got = train.compare(p.readings, ref)
    assert all(got[k] <= TOL[k] for k in TOL), got


def test_control_is_far_from_the_reference():
    cfg, mix = tiny.config("hstu_large"), tiny.mix("train_long")
    ref = train.reference_readings(cfg, mix, 17, CPU)
    ctl = train.compare(train.reference_readings(cfg, mix, 17, CPU, "fp8"),
                        ref)
    p = train.Program(cfg, mix, 17, CPU)
    p.checked_run(mix["checked_steps"])
    got = train.compare(p.readings, ref)
    assert ctl["grad_gap"] > 3 * got["grad_gap"], (ctl, got)


@pytest.mark.parametrize("name", [w["name"] for w in
                                  common.benchmark()["workloads"]
                                  if tiny.mix(w["traffic"])["kind"] ==
                                  "train"])
def test_control_fails_the_cells_limits(name):
    w = common.cell(name)
    cfg, mix = tiny.config(w["config"]), tiny.mix(w["traffic"])
    ref = train.reference_readings(cfg, mix, 17, CPU)
    ctl = train.compare(train.reference_readings(cfg, mix, 17, CPU, "fp8"),
                        ref)
    assert not control.judge(ctl, common.limits(name)), ctl


def test_serving_answers_agree_with_the_reference():
    cfg, mix = tiny.config("hstu_large"), tiny.mix("serve_open")
    client = serve.Client(mix, cfg["vocab_size"])
    eng, model = serve.build(cfg, mix, 23, CPU, client)
    serve.open_loop(eng, client, mix, 23, mix["rate_per_s"], 2.0)
    sample = serve.check_sample(client, mix, 23)
    assert len(sample) == mix["checked_requests"]
    gaps = serve.served_gaps(cfg, client, sample, 23, CPU)
    assert max(gaps) < 0.5, gaps
    ctl = serve.served_gaps(cfg, client, sample, 23, CPU,
                            answers=serve.control_answers(cfg, client,
                                                          sample, 23, CPU))
    assert max(ctl) > max(gaps)
