"""Small parts of the API of ported modules, each against the reference
on the CPU: the deprecated driver spellings of ``FenixConfig`` (the
reference's tests/test_driver_api.py), ``EngineConfig(dense_backlog=
True)`` and the O(n^2) backlog count (tests/test_data_engine.py),
``EngineModel.num_classes``, Appendix A's ``expected_period`` and
``mean_period_over_flows`` (tests/test_probability.py), and
``run_trace``'s deprecated keywords.  The deprecated keywords are
spelled through ``**{...}`` dicts, as tools/check_deprecated.py asks of
every file but the reference's shim and its tests."""

import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, tiny_int8_pair
from repro.core import probability as jprob
from repro.core.data_engine import engine as jde
from repro.core.data_engine import state as jstate
from repro.core.fenix import FenixConfig as JFenixConfig
from repro.data.synthetic_traffic import make_flows
from repro_torch.core import probability as tprob
from repro_torch.core.data_engine import engine as de
from repro_torch.core.data_engine import state as tstate
from repro_torch.core.fenix import FenixConfig, FenixSystem
from repro_torch.core.model_engine.inference import ByLenModel

LEGACY = ("fast_mode", "device_path", "pipes_path", "farm_path")
FIVE = ("src_ip", "dst_ip", "src_port", "dst_port", "proto")


def _resolve(cls, **kw):
    """(driver, exact, the DeprecationWarnings raised) of ``cls(**kw)``,
    or the ValueError's class and message."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            cfg = cls(**kw)
        except ValueError as err:
            return ValueError, str(err)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert all(getattr(cfg, k) is None for k in LEGACY)
    return cfg.driver, cfg.exact, [str(w.message) for w in dep]


@pytest.mark.parametrize("fm,dp,pp,fp", list(itertools.product(
    (False, True), repeat=4)))
def test_legacy_cube_resolves_as_the_reference(fm, dp, pp, fp):
    """The whole 4-bool cube: the port's shim lands on the reference's
    (driver, exact) with the same single DeprecationWarning, or raises
    the reference's ValueError; at two pipes and two engines too."""
    legacy = dict(zip(LEGACY, (fm, dp, pp, fp)))
    for extra in ({}, {"num_pipes": 2}, {"num_pipes": 2, "num_engines": 2}):
        want = _resolve(JFenixConfig, **legacy, **extra)
        got = _resolve(FenixConfig, **legacy, **extra)
        if want[0] is ValueError:
            assert got[0] is ValueError, (legacy, extra, got)
            continue
        assert got == want, (legacy, extra)
        assert len(got[2]) == 1


def test_legacy_spellings_conflict_as_in_the_reference():
    """Partial spellings, and a legacy boolean beside driver=, resolve or
    raise as the reference's do; new code warns nothing."""
    cases = [{"fast_mode": False}, {"device_path": True},
             {"pipes_path": False, "num_pipes": 2},
             {"farm_path": False, "num_engines": 2},
             {"driver": "host", "fast_mode": True},
             {"exact": True, "device_path": False}]
    for kw in cases:
        want, got = _resolve(JFenixConfig, **kw), _resolve(FenixConfig, **kw)
        assert (got[0] is ValueError) == (want[0] is ValueError), kw
        if want[0] is ValueError:
            assert ("not both" in got[1]) == ("not both" in want[1]), kw
        else:
            assert got == want, kw
    assert _resolve(FenixConfig, driver="host", exact=True) == \
        ("host", True, [])


def test_run_trace_unknown_keyword_raises_type_error():
    sys_ = FenixSystem(FenixConfig(batch_size=64), ByLenModel(),
                       device="cpu")
    with pytest.raises(TypeError, match="traces"):
        sys_.run_trace(**{"traces": {}})


def _batches(rng, n_flows, n, steps):
    flows = jstate.make_packets(rng, n_flows)
    t = 1000
    for _ in range(steps):
        pick = rng.integers(0, n_flows, n)
        pk = {k: flows[k][pick] for k in FIVE}
        pk["pkt_len"] = rng.integers(40, 1500, n).astype(np.int32)
        t_next = t + int(rng.integers(1, 3 * n))
        pk["ts_us"] = np.sort(rng.integers(t, t_next, n)).astype(np.int32)
        t = t_next
        yield pk


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else np.array(a))


@pytest.mark.parametrize("n,n_slots", [(1, 4), (77, 4), (500, 64),
                                       (256, 256)])
def test_running_count_dense_matches(n, n_slots):
    """The O(n^2) count == the reference's == the sort/segment count."""
    slot = np.random.default_rng(n).integers(0, n_slots, n)
    dense = de._running_count_dense(torch.from_numpy(slot))
    assert dense.dtype == torch.int32
    assert_same(jde._running_count_dense(jnp.asarray(slot, jnp.int32), n),
                dense)
    assert torch.equal(dense, de._running_count(torch.from_numpy(slot)))


def test_dense_backlog_fast_path_matches():
    """``EngineConfig(dense_backlog=True)``: the whole fast path, batch
    after batch, bit-identical to the reference's dense path and to the
    port's sort/segment path (every output and the state)."""
    jcfg = jstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5,
                               dense_backlog=True)
    tcfg = tstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5,
                               dense_backlog=True)
    seg = tstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5)
    js = jstate.init_state(jcfg, n_est=20, q_est_pps=5e4)
    ts_ = tstate.init_state(tcfg, n_est=20, q_est_pps=5e4, device="cpu")
    ss = tstate.init_state(seg, n_est=20, q_est_pps=5e4, device="cpu")
    rng = np.random.default_rng(3)
    for i, pk in enumerate(_batches(rng, 12, 300, 5)):
        js, jout = jde.process_batch_fast(
            js, {k: jnp.asarray(v) for k, v in pk.items()}, jcfg)
        ts_, tout = de.process_batch_fast(
            ts_, {k: _t(v) for k, v in pk.items()}, tcfg)
        ss, sout = de.process_batch_fast(
            ss, {k: _t(v) for k, v in pk.items()}, seg)
        assert_same(jout, tout, f"out {i}")
        assert_same(js, ts_, f"state {i}")
        assert_same(tout, sout, f"sort/segment out {i}")
        assert_same(ts_, ss, f"sort/segment state {i}")


def test_engine_model_num_classes():
    jmodel, tmodel = tiny_int8_pair(make_flows("iscx", 40, seed=1,
                                               min_per_class=4))
    assert tmodel.num_classes == jmodel.num_classes == tmodel.cfg.num_classes


def test_expected_period_and_fairness_match():
    """Appendix A: Eq. 6 and the rate-weighted mean (Eq. 7-11), equal to
    the reference's and to N/V for any rate distribution."""
    n, q, v = 1000.0, 1.0, 0.075
    for qi in (0.05, 0.5, 3.0):
        assert tprob.expected_period(qi, n, q, v) == \
            jprob.expected_period(qi, n, q, v)
    for seed in range(5):
        rng = np.random.default_rng(seed)
        rates = rng.lognormal(0, 1.5, 50 + seed) + 1e-3
        q = rates.sum()
        v = q / 10.0
        got = tprob.mean_period_over_flows(rates, n=len(rates), q=q, v=v)
        assert got == jprob.mean_period_over_flows(rates, n=len(rates), q=q,
                                                   v=v)
        assert np.isclose(got, len(rates) / v, rtol=1e-9)
