"""Small parts of the API of ported modules, each against the reference
on the CPU: the deprecated driver spellings of ``FenixConfig`` (the
reference's tests/test_driver_api.py), ``EngineConfig(dense_backlog=
True)`` and the O(n^2) backlog count (tests/test_data_engine.py),
``EngineModel.num_classes``, Appendix A's ``expected_period`` and
``mean_period_over_flows`` (tests/test_probability.py), and
``run_trace``'s deprecated keywords.  The deprecated keywords are
spelled through ``**{...}`` dicts, as tools/check_deprecated.py asks of
every file but the reference's shim and its tests.

Then the names and call forms that tests/test_torch_surface.py holds by
source, each held here by behaviour: the package and config
re-exports, ``make_packets``, ``window_reset(state, cfg, now)`` and
``window_reset_pipes``, ``control_plane_update_pipes``'s ``num_pipes``,
``init_dense``, ``maybe_scan``'s ``use_scan``, ``decode_attention``'s
``ck``, ``FenixSystem``'s positional estimates, ``FenixConfig``'s field
order, and the dry runs' refusal of the TPU meshes and sharding rules."""

import dataclasses
import itertools
import subprocess
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.configs as jconfigs
import repro_torch
import repro_torch.configs as tconfigs
from _torch_parity import assert_close, assert_same, tiny_int8_pair
from repro.core import probability as jprob
from repro.core.data_engine import engine as jde
from repro.core.data_engine import flow_tracker as jft
from repro.core.data_engine import rate_limiter as jrl
from repro.core.data_engine import state as jstate
from repro.core.fenix import FenixConfig as JFenixConfig
from repro.data.synthetic_traffic import make_flows
from repro.kernels.decode_attention import ops as jattn
from repro.models import layers as jlayers
from repro.models import param as jparam
from repro_torch.configs import fenix_models as tfenix_models
from repro_torch.core import probability as tprob
from repro_torch.core.data_engine import engine as de
from repro_torch.core.data_engine import flow_tracker as tft
from repro_torch.core.data_engine import rate_limiter as trl
from repro_torch.core.data_engine import state as tstate
from repro_torch.core.fenix import FenixConfig, FenixSystem
from repro_torch.core.model_engine.inference import ByLenModel
from repro_torch.kernels.decode_attention import ops as tattn
from repro_torch.launch import dryrun, run_all_dryruns
from repro_torch.models import layers as tlayers
from repro_torch.models import param as tparam
from repro_torch.models.param import params_from_numpy

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


# ---------------------------------------------------------------------------
# The names and call forms of tests/test_torch_surface.py, by behaviour
# ---------------------------------------------------------------------------


def test_package_and_config_reexports():
    """``from repro_torch import get_config`` and the configs package's
    traffic-model names: the same objects as ``repro_torch.configs.*``,
    naming what the reference's re-exports name."""
    for name in ("SHAPES", "get_config", "list_archs"):
        assert getattr(repro_torch, name) is getattr(tconfigs, name)
    assert sorted(repro_torch.SHAPES) == sorted(repro.SHAPES)
    assert list(repro_torch.list_archs()) == list(repro.list_archs())
    for name in ("TrafficModelConfig", "fenix_cnn", "fenix_rnn"):
        assert getattr(tconfigs, name) is getattr(tfenix_models, name)
    for fn in ("fenix_cnn", "fenix_rnn"):
        assert dataclasses.asdict(getattr(tconfigs, fn)(5)) == \
            dataclasses.asdict(getattr(jconfigs, fn)(5))


@pytest.mark.parametrize("n", [0, 1, 257])
def test_make_packets_bit_identical(n):
    """Equal generator states give the reference's batch: every key,
    value and dtype, and the generators end in the same state."""
    ra, rb = np.random.default_rng(n), np.random.default_rng(n)
    want, got = jstate.make_packets(ra, n), tstate.make_packets(rb, n)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert ra.integers(0, 2**62) == rb.integers(0, 2**62)


def _windowed(rng, jstate_, tstate_, lead=()):
    """Each package's own fresh state (equal leaf by leaf), given the same
    random window counters and clock, as (reference, port) dicts."""
    assert_same(jstate_, tstate_)
    draws = {"flow_cnt": (0, 500), "win_pkt_cnt": (0, 50_000),
             "t_last": (10**5, 10**7), "win_start": (0, 10**5)}
    js, ts_ = dict(jstate_), dict(tstate_)
    for k, (lo, hi) in draws.items():
        v = rng.integers(lo, hi, lead).astype(np.int32)
        js[k], ts_[k] = jnp.asarray(v), torch.from_numpy(v)
    return js, ts_


def test_window_reset_takes_cfg_and_matches():
    """``window_reset(state, cfg, now)`` in the reference's order,
    bit-identical (the rate limiter's rollover calls it so: the pipes
    tests hold ``control_plane_update`` to the reference's)."""
    cfg = jstate.EngineConfig(n_slots_log2=6)
    tcfg = tstate.EngineConfig(n_slots_log2=6)
    rng = np.random.default_rng(11)
    js, ts_ = _windowed(
        rng, jstate.init_state(cfg, n_est=50, q_est_pps=1e4),
        tstate.init_state(tcfg, n_est=50, q_est_pps=1e4, device="cpu"))
    for now in rng.integers(10**5, 10**7, 3).astype(np.int32):
        assert_same(jft.window_reset(js, cfg, jnp.asarray(now)),
                    tft.window_reset(ts_, tcfg, torch.tensor(now)))


def test_window_reset_pipes_and_num_pipes_match():
    """``window_reset_pipes`` anchors each pipe at its own ``t_last``;
    ``control_plane_update_pipes(s, cfg, num_pipes)`` binds as the
    reference's, and ``num_pipes`` changes nothing (the stacked leading
    dimension is authoritative).  ``window_reset`` on the stacked state:
    the reference writes 0-d zero counters, the port keeps their [P]
    shape (``zeros_like``); the values and every other leaf agree."""
    p = 4
    jl = jstate.local_engine_config(jstate.EngineConfig(n_slots_log2=6), p)
    tl = tstate.local_engine_config(tstate.EngineConfig(n_slots_log2=6), p)
    rng = np.random.default_rng(p)
    js, ts_ = _windowed(
        rng, jstate.init_pipes_state(jl, p, n_est=80, q_est_pps=2e4),
        tstate.init_pipes_state(tl, p, n_est=80, q_est_pps=2e4,
                                device="cpu"), (p,))
    got = tft.window_reset_pipes(ts_, tl)
    assert_same(jft.window_reset_pipes(js, jl), got)
    assert torch.equal(got["win_start"], ts_["t_last"])
    now = rng.integers(10**5, 10**7, (p,)).astype(np.int32)
    want = jft.window_reset(js, jl, jnp.asarray(now))
    got = tft.window_reset(ts_, tl, torch.from_numpy(now))
    for k in ("flow_cnt", "win_pkt_cnt"):
        assert want[k].shape == () and got[k].shape == (p,), k
        want[k] = jnp.broadcast_to(want[k], (p,))
    assert_same(want, got)
    want = jrl.control_plane_update_pipes(js, jl, p)
    for n in (p, 0, 1):
        assert_same(want, trl.control_plane_update_pipes(ts_, tl, n))
    assert_same(want, trl.control_plane_update_pipes(ts_, tl))


def test_init_dense_registry_matches():
    """``init_dense`` registers the reference's paths, shapes and logical
    axes, with ``("normal", scale)`` for the kernel and ``("zeros",
    None)`` for the bias, and draws the reference's values."""
    cases = [("a", (8, 12), ("embed", "mlp"), {}),
             ("b", (8, 2, 4), ("embed", "heads", "head_dim"),
              {"bias": True, "bias_axes": ("heads", "head_dim"),
               "scale": 0.5}),
             ("c", (6, 10), ("embed", "vocab"), {"bias": True})]
    jreg = jparam.Registrar(seed=3, dtype=jnp.float32)
    treg = tparam.Registrar(seed=3, dtype=torch.float32)
    for path, shape, axes, kw in cases:
        jlayers.init_dense(jreg, path, shape, axes, **kw)
        tlayers.init_dense(treg, path, shape, axes, **kw)
    assert treg.axes == jreg.axes
    assert {k: tuple(v.shape) for k, v in treg.params.items()} == \
        {k: tuple(v.shape) for k, v in jreg.params.items()}
    assert treg.inits == {"a/w": ("normal", None), "b/w": ("normal", 0.5),
                          "b/b": ("zeros", None), "c/w": ("normal", None),
                          "c/b": ("zeros", None)}
    assert_same(jreg.params, treg.params)


def test_maybe_scan_use_scan_is_the_same_loop():
    """``maybe_scan(body, carry, stacked, use_scan)``: both values give
    the same carry and stacked ys, bit for bit, equal to the reference's
    scan and its unrolled loop (integer arithmetic, so equal means
    equal)."""
    rng = np.random.default_rng(5)
    w = rng.integers(-3, 4, (5, 4)).astype(np.int32)
    b = rng.integers(-9, 10, (5, 4)).astype(np.int32)
    x0 = rng.integers(-5, 6, (4,)).astype(np.int32)

    def body(x, p):
        y = x * p["w"] + p["b"]
        return y, {"y": y, "s": y.sum()}

    tstacked = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    jstacked = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    outs = [tparam.maybe_scan(body, torch.from_numpy(x0), tstacked, flag)
            for flag in (True, False)]
    outs.append(tparam.maybe_scan(body, torch.from_numpy(x0), tstacked))
    for out in outs[1:]:
        assert_same(list(outs[0]), list(out))
    for flag in (True, False):
        assert_same(list(jparam.maybe_scan(body, jnp.asarray(x0), jstacked,
                                           flag)), list(outs[0]))


def test_decode_attention_ck_binds_and_changes_nothing():
    """``decode_attention(q, k, v, lengths, ck)``: ``ck`` in the
    reference's position; the result within the kernel tests' float32
    bound of the reference's and identical for every ``ck``; a ``ck``
    that is not a positive int raises ``ValueError``."""
    b, hq, hkv, d, s = 2, 8, 2, 16, 40
    rng = np.random.default_rng(8)
    x = {"q": rng.normal(0, 1, (b, hq, d)).astype(np.float32),
         "k": rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32),
         "v": rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32),
         "lens": np.array([s, 17], np.int32)}
    t = params_from_numpy(x, "cpu")
    args = (t["q"], t["k"], t["v"], t["lens"])
    want = np.asarray(jattn.decode_attention(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "lens")), 256,
        backend="ref"))
    base = tattn.decode_attention(*args)
    assert_close(want, base, 1e-5)
    for ck in (1, 256, 1024, s + 1, np.int64(64)):
        assert torch.equal(tattn.decode_attention(*args, ck), base), ck
        assert torch.equal(tattn.decode_attention(*args, ck, "ref"), base)
        assert torch.equal(tattn.decode_attention(*args, ck=ck,
                                                  backend="ref"), base)
    for bad in (0, -1, 2.5, True, None, "8"):
        with pytest.raises(ValueError, match="ck"):
            tattn.decode_attention(*args, bad)


def test_fenix_system_estimates_bind_positionally():
    """The reference's positional ``(cfg, model, tree, tree_depth,
    oracle_windows, n_est, q_est_pps)``: the same state as by keyword."""
    cfg = FenixConfig(batch_size=64)
    pos = FenixSystem(cfg, ByLenModel(), None, 4, None, 300.0, 5e4,
                      device="cpu")
    kw = FenixSystem(cfg, ByLenModel(), device="cpu", n_est=300.0,
                     q_est_pps=5e4)
    assert (pos.n_est, pos.q_est_pps) == (300.0, 5e4)
    assert_same(pos.state, kw.state)


def test_fenix_config_fields_bind_positionally():
    """``FenixConfig``'s fields start with the reference's, in its order,
    so a positional call binds each value to the same field (the port's
    own ``step_backend`` comes last)."""
    ref = [f.name for f in dataclasses.fields(JFenixConfig)]
    port = [f.name for f in dataclasses.fields(FenixConfig)]
    assert port[:len(ref)] == ref and port[len(ref):] == ["step_backend"]
    values = (jstate.EngineConfig(), None, 64, 5, 4, "host", True)
    jcfg = JFenixConfig(*values)
    tcfg = FenixConfig(tstate.EngineConfig(), *values[1:])
    for name in ("batch_size", "loop_latency_us", "control_plane_every",
                 "driver", "exact"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.fixture
def no_dry_run(monkeypatch):
    """A refused dry run starts nothing: no subprocess, no trace."""
    def refuse(*a, **k):
        raise AssertionError("a refused dry run started work")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(dryrun, "build_step", refuse)
    monkeypatch.setattr(dryrun, "trace", refuse)


@pytest.mark.parametrize("mesh,rules", [("single", {}), ("multi", {}),
                                        ("card", {"batch": "data"})])
def test_dry_runs_refuse_the_tpu_meshes(mesh, rules, no_dry_run, tmp_path):
    """The reference's ``run_dryrun(arch, shape, mesh, sets, rules, out)``
    and ``run_cell(arch, shape, mesh_kind, overrides, rule_overrides)``
    bind in the port, and its pod meshes ("single" 16x16, "multi"
    2x16x16) and sharding rules are refused with ``ValueError`` before
    any work; so are the CLI's ``--meshes`` and ``--rule``."""
    out = str(tmp_path / "cell.json")
    rule_list = [f"{k}={v}" for k, v in rules.items()]
    with pytest.raises(ValueError, match="mesh"):
        run_all_dryruns.run_dryrun("llama3.2-1b", "decode_32k", mesh, {},
                                   rule_list, out)
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("llama3.2-1b", "decode_32k", mesh, {},
                        rule_overrides=rules)
    argv = ["--only", "llama3.2-1b", "--shapes", "decode_32k",
            "--out-dir", str(tmp_path), "--meshes", mesh]
    for r in rule_list:
        argv += ["--rule", r]
    with pytest.raises(SystemExit):
        run_all_dryruns.main(argv)
    assert not (tmp_path / "baseline").exists()
