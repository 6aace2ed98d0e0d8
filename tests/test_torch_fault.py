"""The port's own copy of the fault-tolerance runtime
(`repro_torch.runtime.fault`) against the reference's
(`repro.runtime.fault`): the same schedules give identical results.

Mirrors `TestFaultRunner`, `TestStraggler`, `TestElastic` and
`TestHeartbeat` of tests/test_runtime.py, run through both modules.
"""

import math

import pytest

from repro.runtime import fault as jfault
from repro_torch.runtime import fault

MODULES = {"reference": jfault, "port": fault}


def both(fn):
    """fn(module) for the reference and the port -> (ref, port)."""
    return fn(jfault), fn(fault)


# --------------------------------------------------------------------------
# FaultTolerantRunner
# --------------------------------------------------------------------------

def run_schedule(m, schedule, n_steps=20, ckpt_every=5, nan_at=()):
    saves = {0: {"x": 0}}
    events = []
    poisoned = set(nan_at)      # each poisons its step's first run only

    def step_fn(state, step):
        loss = 1.0 / (step + 1)
        if step in poisoned:
            poisoned.discard(step)
            loss = float("nan")
        return {"x": state["x"] + 1}, dict(loss=loss)

    def save_fn(step, state):
        events.append(("save", step))
        saves[step] = dict(state)

    def restore_fn():
        step = max(saves)
        events.append(("restore", step))
        return dict(saves[step]), step

    runner = m.FaultTolerantRunner(step_fn, save_fn, restore_fn,
                                   m.FailureInjector(dict(schedule)),
                                   ckpt_every=ckpt_every)
    state, log = runner.run({"x": 0}, n_steps)
    return runner.restarts, state, log, events


@pytest.mark.parametrize("schedule,ckpt_every,nan_at", [
    ({7: "crash", 13: "nan"}, 5, ()),
    ({0: "crash"}, 1, ()),
    ({3: "nan", 4: "nan", 19: "crash"}, 2, ()),
    ({}, 5, (6,)),
    ({2: "slow:w1", 5: "drop:w2"}, 3, ()),
])
def test_runner_schedules_match(schedule, ckpt_every, nan_at):
    ref, port = both(lambda m: run_schedule(m, schedule, ckpt_every=ckpt_every,
                                            nan_at=nan_at))
    assert port[0] == ref[0]                 # restarts
    assert port[1] == ref[1]                 # final state
    assert port[3] == ref[3]                 # save/restore sequence
    assert [m["step"] for m in port[2]] == [m["step"] for m in ref[2]]
    for a, b in zip(port[2], ref[2]):
        assert a.keys() == b.keys()
        assert (math.isnan(a["loss"]) and math.isnan(b["loss"])) or (
            a["loss"] == b["loss"])


def test_crash_restart_resumes_correctly():
    restarts, state, log, _ = run_schedule(fault, {7: "crash", 13: "nan"})
    assert restarts == 2
    assert state["x"] == 20              # every step eventually executed
    assert log[-1]["step"] == 19


@pytest.mark.parametrize("name", sorted(MODULES))
def test_nan_detection_restores(name):
    m = MODULES[name]
    calls = {"restore": 0}

    def restore_fn():
        calls["restore"] += 1
        return {}, 4                      # skip the poisoned step

    r = m.FaultTolerantRunner(
        lambda s, step: (s, dict(loss=float("nan") if step == 3 else 0.5)),
        lambda *a: None, restore_fn, ckpt_every=100)
    r.run({}, 6)
    assert calls["restore"] == 1 and r.restarts == 1


@pytest.mark.parametrize("name", sorted(MODULES))
def test_injector_fires_once(name):
    inj = MODULES[name].FailureInjector({2: "crash"})
    assert [inj.check(s) for s in (0, 1, 2, 2, 3)] == [
        None, None, "crash", None, None]
    assert inj.fired == {2}


# --------------------------------------------------------------------------
# StragglerPolicy
# --------------------------------------------------------------------------

DURATIONS = [
    {f"w{i}": 1.0 for i in range(15)} | {"w15": 10.0},
    {f"w{i}": 1.0 + 0.01 * i for i in range(16)},
    {"a": 3.0, "b": 1.0, "c": 2.0},
    {"solo": 4.0},
    {},
    {f"w{i}": float(i % 5) + 0.5 for i in range(32)},
]


@pytest.mark.parametrize("durations", DURATIONS)
@pytest.mark.parametrize("quorum,deadline", [(0.9375, 2.0), (0.75, 2.0),
                                             (0.5, 1.0), (1.0, 3.0)])
def test_admit_lists_and_rescale_match(durations, quorum, deadline):
    ref, port = both(lambda m: m.StragglerPolicy(
        quorum_fraction=quorum, deadline_factor=deadline).admit(
            dict(durations)))
    assert port == ref


def test_drops_only_stragglers():
    pol = fault.StragglerPolicy(quorum_fraction=0.75, deadline_factor=2.0)
    admitted, rescale = pol.admit(DURATIONS[0])
    assert "w15" not in admitted and len(admitted) == 15
    assert abs(rescale - 16 / 15) < 1e-9


# --------------------------------------------------------------------------
# replan_mesh / ElasticPlan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [1, 2, 16])
def test_replan_mesh_matches(model_parallel):
    for survivors in range(1, 33):
        ref = jfault.replan_mesh(survivors, model_parallel=model_parallel)
        port = fault.replan_mesh(survivors, model_parallel=model_parallel)
        assert (port.data, port.model, port.devices) == (
            ref.data, ref.model, ref.devices), survivors
        assert port.devices <= survivors


def test_replan_keeps_and_degrades_model_parallel():
    assert fault.replan_mesh(240, model_parallel=16) == fault.ElasticPlan(
        data=15, model=16)
    p = fault.replan_mesh(12, model_parallel=16)
    assert p.devices <= 12 and p.model == 8


# --------------------------------------------------------------------------
# HeartbeatMonitor
# --------------------------------------------------------------------------

def heartbeat_trace(m):
    t = {"now": 0.0}
    hb = m.HeartbeatMonitor(["a", "b", "c"], timeout_s=5.0,
                            clock=lambda: t["now"])
    out = []
    for now, beats in ((3.0, "a"), (4.0, "c"), (7.0, "a"), (9.5, ""),
                       (12.0, "b"), (20.0, "")):
        t["now"] = now
        for w in beats:
            hb.beat(w)
        out.append((hb.dead(), hb.alive(), hb.dead(now=now + 10.0)))
    hb.beat("c", at=100.0)
    out.append((hb.dead(now=104.0), hb.alive(now=104.0)))
    return out


def test_dead_and_alive_on_an_injected_clock_match():
    ref, port = both(heartbeat_trace)
    assert port == ref
    assert port[2][0] == ["b"] and port[2][1] == ["a", "c"]
