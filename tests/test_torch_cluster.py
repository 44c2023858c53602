"""``tests/test_cluster.py``'s six claims and
``tests/test_resource_groups.py::test_supervisor_integration`` through the
port's ``ClusterSupervisor``: every attempt is a world of real rank
processes (gloo, the CPU; ``multihost.launch_world``), and every answer
is rank 0's host ``Table``, equal at tolerance 0 (names, types, values in
row order) to the port's ``LocalRunner(device="cpu")``, and for ``Q`` and
TPC-H Q5 to the JAX package's ``LocalRunner`` (one JAX run per query).

The reference supervises 8 workers and replays on 7.  Here a death
replays a world of 3 ranks on 2, a healthy run and the resource group
take worlds of 2-3, and the other claims need no more.  A death is
either a worker whose heartbeats stop mid-attempt (``kill_worker``, as
the reference) or a rank process that really exits
(``torch_dist_ranks.fail_on`` put first in the attempt's job list)."""

import time

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.tpch.queries import QUERIES
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.parallel import worker as W
from presto_tpu_torch.parallel.cluster import (ClusterSupervisor,
                                               WorkerLostError)
from presto_tpu_torch.parallel.multihost import WorldFailed
from presto_tpu_torch.parallel.resource_groups import (ResourceGroup,
                                                       ResourceGroupManager)

SF = 0.01
Q = ("select o_orderpriority, count(*) as order_count from orders "
     "where o_orderdate >= date '1993-07-01' group by o_orderpriority "
     "order by o_orderpriority")
FAIL_ON = "tests.torch_dist_ranks:fail_on"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def local():
    return LocalRunner(scale_factor=SF, device="cpu")


@pytest.fixture(scope="module")
def jax_runner():
    return JaxRunner(scale_factor=SF)


@pytest.fixture()
def supervisors():
    sups = []

    def make(*args, **kw):
        sup = ClusterSupervisor(*args, device="cpu", **kw)
        sups.append(sup)
        return sup
    yield make
    for s in sups:
        s.shutdown()


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


def assert_same(got, want):
    """Tolerance 0: the same columns, types and values in row order."""
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype), c
    assert _cols(got) == _cols(want)


def _wait_dead(sup, wid, timeout=5.0):
    deadline = time.monotonic() + timeout
    while sup.detector.is_alive(wid):
        assert time.monotonic() < deadline, "worker never marked dead"
        time.sleep(0.02)


def _kill_once(sup, i):
    state = {"killed": False}

    def hook(participants):
        # fires inside the first attempt, after its participant snapshot,
        # i.e. while the query is logically in flight
        if not state["killed"]:
            state["killed"] = True
            sup.kill_worker(i)
            _wait_dead(sup, f"worker-{i}")
    return hook


def _exit_once(rank):
    state = {"failed": False}

    def hook(participants, spec):
        if not state["failed"]:
            state["failed"] = True
            spec["jobs"].insert(0, {"name": "die", "call": FAIL_ON,
                                    "args": {"rank": rank}})
    return hook


def test_worker_death_mid_query_replays_on_survivors(local, jax_runner,
                                                     supervisors):
    sup = supervisors(SF, n_workers=3, min_workers=2,
                      broadcast_row_limit=3000)
    sup.on_attempt_start.append(_kill_once(sup, 1))
    got = sup.run_sql(Q)
    assert_same(got, local.run_sql(Q))
    assert _cols(got) == _cols(jax_runner.run_sql(Q))
    assert sup.attempts == 2, "first attempt must be invalidated"
    assert sup.restarts == 1
    # the replay ran on the 2 survivors
    assert sup.attempt_worlds == [3, 2]
    assert sup.detector.active() == ["worker-0", "worker-2"]


def test_rank_process_exit_replays_on_survivors(local, supervisors):
    """Rank 1's process raises and exits while rank 0 and rank 2 wait in a
    barrier: the world fails, worker-1 is marked dead, and the replay on
    the other two equals the local runner."""
    sup = supervisors(SF, n_workers=3, min_workers=2,
                      broadcast_row_limit=3000)
    sup.on_attempt_spec.append(_exit_once(1))
    got = sup.run_sql(Q)
    assert_same(got, local.run_sql(Q))
    assert sup.attempts == 2 and sup.restarts == 1
    assert sup.attempt_worlds == [3, 2]
    assert sup.detector.active() == ["worker-0", "worker-2"]
    assert not sup.workers[1].alive


def test_healthy_cluster_single_attempt(local, supervisors):
    sup = supervisors(SF, n_workers=3, min_workers=2)
    got = sup.run_sql(Q)
    assert_same(got, local.run_sql(Q))
    assert sup.attempts == 1 and sup.restarts == 0
    assert sup.attempt_worlds == [3]
    assert sup.last_world["world"] == 3
    assert sup.last_world["backend"] == "gloo"


def test_admission_gate_blocks_below_min_workers(supervisors):
    sup = supervisors(SF, n_workers=3, min_workers=3,
                      heartbeat_timeout_s=0.2, admission_timeout_s=0.5)
    sup.kill_worker(0)
    _wait_dead(sup, "worker-0", timeout=2.0)
    with pytest.raises(RuntimeError, match="min_workers"):
        sup.run_sql(Q)
    assert sup.attempts == 0 and sup.attempt_worlds == []


def test_user_error_is_not_retried(supervisors):
    """Every rank raises the same error and records it; the supervisor
    re-raises it with the rank's class and message, after one attempt."""
    sup = supervisors(SF, n_workers=2, min_workers=1)
    with pytest.raises(Exception) as ei:
        sup.run_sql("select nope from nowhere")
    assert not isinstance(ei.value, (WorkerLostError, WorldFailed))
    assert isinstance(ei.value, KeyError)
    assert "unknown table nowhere" in str(ei.value)
    assert sup.attempts == 1, "user errors must not replay"
    assert sup.restarts == 0


@pytest.mark.parametrize("death", ["heartbeat", "exit"])
def test_repeated_deaths_exhaust_attempts(death, supervisors):
    sup = supervisors(SF, n_workers=3, min_workers=1, max_attempts=2,
                      broadcast_row_limit=3000)
    state = {"n": 0}

    def always_kill(participants):
        sup.kill_worker(state["n"])
        _wait_dead(sup, f"worker-{state['n']}")
        state["n"] += 1

    def always_exit(participants, spec):
        spec["jobs"].insert(0, {"name": "die", "call": FAIL_ON,
                                "args": {"rank": 0}})

    if death == "heartbeat":
        sup.on_attempt_start.append(always_kill)
    else:
        sup.on_attempt_spec.append(always_exit)
    with pytest.raises(RuntimeError, match="failed after 2 attempts") as ei:
        sup.run_sql(Q)
    assert sup.attempts == 2 and sup.restarts == 2
    assert sup.attempt_worlds == [3, 2]
    cause = ei.value.__cause__
    if death == "heartbeat":
        assert isinstance(cause, WorkerLostError)
        assert cause.dead == ["worker-1"]
    else:
        # the ranks' output reaches the caller in the chained cause
        assert isinstance(cause, WorldFailed) and cause.rank == 0
        assert "rank 0 fails on purpose" in str(cause)


def test_tpch_q5_survives_death(local, jax_runner, supervisors):
    """A partitioned multi-join query replays correctly too."""
    sup = supervisors(SF, n_workers=3, min_workers=2,
                      broadcast_row_limit=3000)
    sup.on_attempt_start.append(_kill_once(sup, 2))
    got = sup.run_sql(QUERIES[5])
    assert_same(got, local.run_sql(QUERIES[5]))
    assert _cols(got) == _cols(jax_runner.run_sql(QUERIES[5]))
    assert sup.restarts == 1 and sup.attempt_worlds == [3, 2]


def test_supervisor_integration(local, supervisors):
    """The supervisor honors the group's concurrency limit: the statement
    is admitted once and released after it."""
    mgr = ResourceGroupManager([ResourceGroup("g", hard_concurrency_limit=1,
                                              max_queued=4)], [("*", "g")])
    sup = supervisors(SF, n_workers=2, resource_groups=mgr)
    out = sup.run_sql("select count(*) c from nation")
    assert out.to_pydict()["c"] == [25]
    assert_same(out, local.run_sql("select count(*) c from nation"))
    assert mgr.groups["g"].admitted == 1
    assert mgr.groups["g"].running == 0  # released


@pytest.mark.parametrize("kwargs,cards,error", [
    ({}, 0, "no CUDA device"),
    ({"n_workers": 2}, 0, "no CUDA device"),
    ({"n_workers": 2, "device": "cuda:0"}, 1, "2 CUDA ranks need 2 cards"),
    ({"n_workers": 3}, 2, "3 CUDA ranks need 3 cards"),
    ({"device": "cpu"}, 0, "CPU ranks need n_workers"),
])
def test_ranks_run_on_the_card_unless_cpu(kwargs, cards, error, monkeypatch):
    """With no ``device`` the ranks are cards, one each: without enough
    cards the supervisor raises and starts nothing; only ``device="cpu"``
    gives gloo ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises((RuntimeError, ValueError), match=error):
        ClusterSupervisor(SF, **kwargs)


class _TwoArgs(Exception):
    def __init__(self, a, b):
        super().__init__(f"{a} and {b}")


def test_caught_error_that_cannot_be_pickled_comes_back_named():
    """A rank hands its caught error back pickled; one whose class cannot
    be rebuilt from its args comes back as a RuntimeError naming it, so
    that writing it never fails the world (which would replay a user
    error)."""
    e = KeyError("unknown table nowhere")
    assert W._portable(e) is e
    got = W._portable(_TwoArgs(1, 2))
    assert type(got) is RuntimeError and str(got) == "_TwoArgs: 1 and 2"
