"""The port's retry, straggler and elastic-planning primitives against the
reference's, on the CPU.

Twins of ``tests/test_runtime.py``: every scenario runs through
``repro.runtime`` and ``repro_torch.runtime`` with ``time.sleep`` (and,
where the deadline matters, ``time.perf_counter``) replaced, and the two
must sleep the same sleeps float for float (the seeded jitter draws through
``np.random.default_rng`` in both), call the same number of times, flag the
same stragglers and plan the same meshes and placements.
"""
import time

import numpy as np
import pytest

import repro.runtime as R
import repro_torch.runtime as T
from repro_torch.runtime import resilience as tres


class _Boom(RuntimeError):
    pass


class _Fatal(ValueError):
    pass


def _failing(n_failures, exc=_Boom):
    """A callable that raises ``exc`` for its first ``n_failures`` calls."""
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise exc(f"fail {calls['n']}")
        return calls["n"]

    fn.calls = calls
    return fn


def _retry(mod, monkeypatch, n_failures, policy_kw, exc=_Boom, on_retry=None):
    """Run ``with_retries`` of ``mod`` over a callable failing ``n_failures``
    times: ``(result or raised type, sleeps, calls)``."""
    sleeps = []
    monkeypatch.setattr(tres.time, "sleep", sleeps.append)
    fn = _failing(n_failures, exc)
    try:
        out = mod.with_retries(fn, mod.RetryPolicy(**policy_kw), on_retry=on_retry)
    except (_Boom, _Fatal) as e:
        out = type(e)
    return out, sleeps, fn.calls["n"]


def test_with_retries_backoff_sequencing(monkeypatch):
    kw = dict(max_attempts=4, backoff_s=0.1, backoff_mult=3.0, retryable=(_Boom,), jitter=0.0)
    got, want = (_retry(mod, monkeypatch, 2, kw) for mod in (T, R))
    assert got == want
    out, sleeps, calls = got
    assert out == 3 and calls == 3
    assert sleeps == pytest.approx([0.1, 0.3])  # geometric, no jitter


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_with_retries_jitter_is_seeded_like_the_reference(monkeypatch, seed):
    kw = dict(max_attempts=6, backoff_s=0.1, backoff_mult=3.0, retryable=(_Boom,),
              jitter=0.5, seed=seed)
    got, want = (_retry(mod, monkeypatch, 10, kw) for mod in (T, R))
    assert got == want  # the same sleeps, float for float
    out, sleeps, _ = got
    assert out is _Boom and len(sleeps) == 5
    prev = 0.1 / 3.0
    for s in sleeps:  # inside the decorrelated-jitter envelope
        assert 0.1 <= s < prev * 3.0 * 1.5 + 1e-12
        prev = s
    other = _retry(T, monkeypatch, 10, dict(kw, seed=seed + 100))[1]
    assert other != sleeps  # other seeds decorrelate


def test_with_retries_sleep_capped_to_deadline(monkeypatch):
    def run(mod):
        sleeps, clock = [], {"t": 0.0}

        def fake_sleep(s):
            sleeps.append(s)
            clock["t"] += s

        monkeypatch.setattr(tres.time, "perf_counter", lambda: clock["t"])
        monkeypatch.setattr(tres.time, "sleep", fake_sleep)
        fn = _failing(10)
        policy = mod.RetryPolicy(max_attempts=50, backoff_s=10.0, backoff_mult=2.0,
                                 retryable=(_Boom,), deadline_s=1.0, jitter=0.0)
        with pytest.raises(_Boom):
            mod.with_retries(fn, policy)
        return sleeps, fn.calls["n"]

    got, want = run(T), run(R)
    assert got == want
    assert got[0] == pytest.approx([1.0]) and got[1] == 2  # trimmed to the budget


def test_with_retries_on_retry_and_exhaustion(monkeypatch):
    seen = {T: [], R: []}
    for mod in (T, R):
        out, _, calls = _retry(mod, monkeypatch, 10,
                               dict(max_attempts=3, backoff_s=0.01, retryable=(_Boom,)),
                               on_retry=lambda a, e, m=mod: seen[m].append((a, str(e))))
        assert out is _Boom and calls == 3
    # on_retry fires for every attempt but the last, which re-raises.
    assert seen[T] == seen[R] == [(1, "fail 1"), (2, "fail 2")]


def test_with_retries_non_retryable_passthrough(monkeypatch):
    for mod in (T, R):
        out, sleeps, calls = _retry(mod, monkeypatch, 1,
                                    dict(max_attempts=5, retryable=(_Boom,)), exc=_Fatal)
        assert (out, sleeps, calls) == (_Fatal, [], 1)


def test_with_retries_deadline_stops_early(monkeypatch):
    for mod in (T, R):
        out, _, calls = _retry(mod, monkeypatch, 10, dict(
            max_attempts=50, backoff_s=0.0, retryable=(_Boom,), deadline_s=0.0))
        assert out is _Boom and calls == 1  # the deadline was spent at once


@pytest.mark.parametrize("window", [8, 32])
def test_straggler_monitor_matches_reference(window):
    rng = np.random.default_rng(window)
    durations = np.concatenate([np.full(7, 0.01), [0.01, 0.019, 0.05, 0.5],
                                rng.exponential(0.02, 60)])
    t_mon, r_mon = T.StragglerMonitor(window=window), R.StragglerMonitor(window=window)
    for d in durations:
        assert t_mon.median() == r_mon.median()
        assert t_mon.observe(float(d)) == r_mon.observe(float(d))
    assert t_mon.flagged == r_mon.flagged > 0


def test_straggler_monitor_warmup_and_flagging():
    mon = T.StragglerMonitor(window=32, threshold=2.0)
    for _ in range(7):  # below max(4, window // 4) = 8 there is no baseline
        assert mon.median() is None
        assert mon.observe(0.01) is False
    assert mon.observe(0.01) is False
    assert mon.median() == pytest.approx(0.01)
    assert mon.observe(0.019) is False
    assert mon.observe(0.05) is True
    assert mon.observe(0.5) is True and mon.flagged == 2
    small = T.StragglerMonitor(window=8)
    for _ in range(3):
        small.observe(1.0)
    assert small.median() is None  # the warmup floor is 4
    small.observe(1.0)
    assert small.median() == pytest.approx(1.0)


def test_feasible_mesh_shape_matches_reference():
    for n in range(0, 33):
        for mp in (1, 2, 4, 8):
            for pods in (1, 2, 3, 4):
                assert (T.feasible_mesh_shape(n, mp, pods)
                        == R.feasible_mesh_shape(n, mp, pods)), (n, mp, pods)
    assert T.feasible_mesh_shape(8, 2) == (4, 2)
    assert T.feasible_mesh_shape(1, 2) is None
    assert T.feasible_mesh_shape(8, 2, prefer_pods=2) == (2, 2, 2)


@pytest.mark.parametrize("n_devices", [8, 7, 6, 5, 4])
def test_plan_remesh_preserves_global_batch(n_devices):
    global_batch, model_parallel = 32, 2
    plan = T.plan_remesh(n_devices, model_parallel, global_batch,
                         old_n_micro=2, old_data_extent=4)
    want = R.plan_remesh(n_devices, model_parallel, global_batch,
                         old_n_micro=2, old_data_extent=4)
    assert (plan.mesh_shape, plan.axis_names, plan.n_micro, plan.dropped_devices) == (
        want.mesh_shape, want.axis_names, want.n_micro, want.dropped_devices)
    data_extent = plan.mesh_shape[-2] * (
        plan.mesh_shape[0] if len(plan.mesh_shape) == 3 else 1)
    assert global_batch % plan.n_micro == 0
    if global_batch % data_extent == 0:
        assert (global_batch // plan.n_micro) % data_extent == 0
    assert int(np.prod(plan.mesh_shape)) + plan.dropped_devices == n_devices


def test_plan_replacement_invariants():
    sizes = np.array([10, 30, 20, 40, 10, 25])
    owner = np.array([0, 0, 1, 1, 2, 2])
    new = T.plan_replacement(sizes, owner, 3, dead=[1])
    assert (new[owner == 0] == 0).all() and (new[owner == 2] == 2).all()
    assert set(new[owner == 1].tolist()) <= {0, 2}
    assert new[3] == 2 and new[2] == 0  # largest orphan to the lighter survivor
    assert np.array_equal(owner, [0, 0, 1, 1, 2, 2])  # input untouched
    rng = np.random.default_rng(0)
    for _ in range(40):
        n_shards = int(rng.integers(2, 7))
        sizes = rng.integers(0, 1000, int(rng.integers(1, 60)))
        owner = rng.integers(0, n_shards, sizes.shape[0])
        dead = sorted(set(rng.integers(0, n_shards, int(rng.integers(1, n_shards))).tolist()))
        np.testing.assert_array_equal(T.plan_replacement(sizes, owner, n_shards, dead),
                                      R.plan_replacement(sizes, owner, n_shards, dead))


def test_plan_replacement_no_survivors():
    with pytest.raises(ValueError):
        T.plan_replacement(np.array([1.0]), np.array([0]), 2, dead=[0, 1])


def test_retry_loop_uses_the_real_clock_by_default():
    """Without a replaced clock the deadline is wall time: a policy with a
    budget of 0.05 s and sleeps of 0.02 s stops within a few sleeps."""
    t0 = time.perf_counter()
    fn = _failing(100)
    with pytest.raises(_Boom):
        T.with_retries(fn, T.RetryPolicy(max_attempts=100, backoff_s=0.02, backoff_mult=1.0,
                                         retryable=(_Boom,), deadline_s=0.05, jitter=0.0))
    assert time.perf_counter() - t0 < 1.0 and 2 <= fn.calls["n"] <= 5
