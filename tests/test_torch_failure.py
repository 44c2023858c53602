"""``tests/test_failure.py``'s four claims through the port's copy of the
failure detector (``presto_tpu_torch/parallel/failure.py``), each beside
the JAX package's detector on the same virtual clock: the decayed ratios,
``active()`` and ``ready()`` are the same values, and ``RestartOnFailure``
replays the same attempts."""

import pytest
import torch

from presto_tpu.parallel import failure as J
from presto_tpu_torch.parallel import failure as P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("decay", [10.0, 60.0])
def test_decayed_ratio(decay):
    ratios = []
    for F in (P, J):
        r = F.DecayedRatio(decay_seconds=decay)
        r.record(False, 0.0)
        assert r.ratio(0.0) == 1.0
        seen = []
        for i in range(1, 20):
            r.record(True, float(i))
            seen.append(r.ratio(float(i) + 0.5))
        ratios.append(seen + [r.ratio(20.0)])
    assert ratios[0] == ratios[1]  # bit for bit
    if decay == 10.0:
        assert ratios[0][-1] < 0.1


def _detectors(**kw):
    clk = Clock()
    return clk, [F.HeartbeatFailureDetector(clock=clk, **kw) for F in (P, J)]


def test_detector_excludes_failing_worker():
    clk, ds = _detectors(failure_ratio_threshold=0.2, heartbeat_timeout_s=30)
    for d in ds:
        d.register("w0")
        d.register("w1")
    for i in range(10):
        clk.t += 1
        for d in ds:
            d.heartbeat("w0", ok=True)
            d.heartbeat("w1", ok=(i % 2 == 0))  # w1 fails half its pings
        assert ds[0].active() == ds[1].active()
        assert [ds[0].workers[w].ratio.ratio(clk.t) for w in ("w0", "w1")] \
            == [ds[1].workers[w].ratio.ratio(clk.t) for w in ("w0", "w1")]
    assert "w0" in ds[0].active()
    assert "w1" not in ds[0].active()


def test_stale_heartbeat_times_out():
    clk, ds = _detectors(heartbeat_timeout_s=5)
    for d in ds:
        d.register("w0")
        d.heartbeat("w0")
    for t in (1.0, 5.0, 5.5, 10.0):
        clk.t = t
        assert ds[0].active() == ds[1].active()
        assert ds[0].is_alive("w0") == ds[1].is_alive("w0")
    assert ds[0].active() == []


def test_cluster_size_gate_and_restart():
    clk, ds = _detectors()
    for d in ds:
        d.register("w0")
        d.register("w1")
        d.heartbeat("w0")
        d.heartbeat("w1")
    assert P.ClusterSizeMonitor(ds[0], 2).ready()
    for n in (1, 2, 3):
        assert P.ClusterSizeMonitor(ds[0], n).ready() == \
            J.ClusterSizeMonitor(ds[1], n).ready()

    runs = []
    for F, d in zip((P, J), ds):
        attempts = []

        def run(workers, attempts=attempts):
            attempts.append(list(workers))
            if len(attempts) == 1:
                raise RuntimeError("worker died mid-query")
            return "ok"

        out = F.RestartOnFailure(run, d).execute()
        assert out == "ok"
        assert len(attempts) == 2
        runs.append(attempts)
    assert runs[0] == runs[1]
    # a failure the rule calls not retryable propagates at once, and
    # repeated retryable ones exhaust max_attempts, in both packages
    for F, d in zip((P, J), ds):
        with pytest.raises(KeyError):
            F.RestartOnFailure(lambda w: {}["x"], d,
                               retryable=lambda e: False).execute()
        with pytest.raises(RuntimeError, match="failed after 2 attempts"):
            F.RestartOnFailure(lambda w: 1 / 0, d, max_attempts=2).execute()
