"""The port's five baseline schemes (BoS, N3IC, FlowLens, Leo,
NetBeacon) against the reference's on the CPU, and each beating chance
on the port.

The same seeded flows go through both packages' generators (each its
own ``make_flows``, equal flows).  BoS and N3IC: inits and features bit
for bit; logits within 1e-5 of the largest logit and the first 20
training losses within 1e-5 relative (float32 in another summation
order, and torch's ``exp`` and ``tanh`` rounding some outputs to the
other neighbour of XLA's; measured: 1.1e-7 of the largest logit, 1.5e-7
relative on the losses; tests/bos_pin_drift.py shows where the two
trainings part at the Table-2 pin's settings).  FlowLens, Leo and NetBeacon fit in numpy on
equal features: their predictions must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same
from repro.baselines import bos as jbos
from repro.baselines import flowlens as jfl
from repro.baselines import leo as jleo
from repro.baselines import n3ic as jn3ic
from repro.baselines import netbeacon as jnb
from repro.configs.fenix_models import fenix_cnn as jfenix_cnn
from repro.data import synthetic_traffic as jst
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.baselines import bos as tbos
from repro_torch.baselines import flowlens as tfl
from repro_torch.baselines import leo as tleo
from repro_torch.baselines import n3ic as tn3ic
from repro_torch.baselines import netbeacon as tnb
from repro_torch.baselines.common import macro_f1
from repro_torch.configs.fenix_models import fenix_cnn as tfenix_cnn
from repro_torch.data import synthetic_traffic as tst
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

K = 7
CHANCE = 1.0 / K


@pytest.fixture(scope="module")
def flows():
    """(reference flows, port flows) of one train and one test set."""
    args = (("iscx", 250, 10, 10), ("iscx", 100, 11, 5))
    ref = [jst.make_flows(t, n, seed=s, min_per_class=m)
           for t, n, s, m in args]
    port = [tst.make_flows(t, n, seed=s, min_per_class=m)
            for t, n, s, m in args]
    for a, b in zip(ref, port):
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            assert fa.label == fb.label
            assert np.array_equal(fa.pkt_len, fb.pkt_len)
            assert np.array_equal(fa.ipd_us, fb.ipd_us)
    return ref, port


def _trainers(jloss, tloss, jp, tp, x, y, w, steps=20):
    """The reference's Trainer and the port's (eager, CPU) from one init
    over the same batches (``batch_iterator``'s draws from one seed)."""
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=steps, weight_decay=0.01)
    ref = jtrainer.Trainer(jloss, jp, jtrainer.TrainerConfig(
        total_steps=steps, log_every=1, opt=jopt.OptConfig(**kw)))
    ref.run(jtrainer.batch_iterator(x, y, 256, seed=1, weights=w))
    port = ttrainer.Trainer(tloss, tp, ttrainer.TrainerConfig(
        total_steps=steps, log_every=1, opt=topt.OptConfig(**kw)),
        device="cpu")
    port.run(ttrainer.batch_iterator(x, y, 256, seed=1, weights=w,
                                     device="cpu"))
    return ref, port


def _same_losses(ref, port):
    rl = np.array([m["loss"] for m in ref.metrics_log])
    pl = np.array([m["loss"] for m in port.metrics_log])
    assert len(rl) == len(pl) == 20
    np.testing.assert_allclose(pl, rl, rtol=1e-5, atol=0)


# -- BoS ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_bos_init_is_bit_identical(seed):
    ref = {k: np.asarray(v) for k, v in jbos.init(jfenix_cnn(K), seed).items()}
    port = tbos.init(tfenix_cnn(K), seed, device="cpu")
    assert_same(ref, port)
    assert all(v.dtype == torch.float32 for v in port.values())


def test_bos_logits_and_losses_match(flows):
    (jtr, _), (ttr, _) = flows
    x, y, _ = jst.windows_from_flows(jtr)
    assert_same(x, tst.windows_from_flows(ttr)[0])
    w = jst.class_weights(y, K)
    jc, tc = jfenix_cnn(K), tfenix_cnn(K)
    jp, tp = jbos.init(jc, 0), tbos.init(tc, 0, device="cpu")
    assert_close(jbos.apply(jp, jc, jnp.asarray(x)),
                 tbos.apply(tp, tc, torch.from_numpy(x)), 1e-5, "logits")
    ref, port = _trainers(lambda p, b: jbos.loss_fn(p, jc, b),
                          lambda p, b: tbos.loss_fn(p, tc, b),
                          jp, tp, x, y, w)
    _same_losses(ref, port)


def test_bos_ste_is_the_reference_op_for_op():
    """``w + (sign(w) - w)`` in float32 (not ``sign(w)``: it is not always
    exactly +-1), and the quantizer's round-half-to-even, bit for bit."""
    rng = np.random.default_rng(3)
    w = np.concatenate([rng.normal(0, 1e-3, 4096), rng.normal(0, 30, 4096),
                        np.arange(-8, 8.5, 0.5) / 15.0]).astype(np.float32)
    assert_same(np.asarray(jbos._binarize_ste(jnp.asarray(w))),
                tbos._binarize_ste(torch.from_numpy(w)))
    for bits in (6, 9):
        assert_same(np.asarray(jbos._quant_ste(jnp.asarray(w), bits, 1.0)),
                    tbos._quant_ste(torch.from_numpy(w), bits, 1.0))


# -- N3IC ---------------------------------------------------------------------


def test_n3ic_features_init_logits_losses_match(flows):
    (jtr, _), (ttr, _) = flows
    x, y, f = jn3ic.build_features(jtr)
    xt, yt, ft = tn3ic.build_features(ttr)
    assert x.dtype == xt.dtype == np.float32
    assert_same((x, y, f), (xt, yt, ft))
    jp, tp = jn3ic.init(x.shape[1], K, 0), tn3ic.init(x.shape[1], K, 0,
                                                      device="cpu")
    assert_same({k: np.asarray(v) for k, v in jp.items()}, tp)
    assert_close(jn3ic.apply(jp, jnp.asarray(x)),
                 tn3ic.apply(tp, torch.from_numpy(xt)), 1e-5, "logits")
    ref, port = _trainers(jn3ic.loss_fn, tn3ic.loss_fn, jp, tp, x, y,
                          jst.class_weights(y, K))
    _same_losses(ref, port)


# -- FlowLens -----------------------------------------------------------------


def test_flowlens_markers_and_gbdt_match(flows):
    (jtr, jte), (ttr, tte) = flows
    jx, jy = jfl.markers(jtr)
    tx, ty = tfl.markers(ttr)
    assert_same((jx, jy), (tx, ty))
    jxe, _ = jfl.markers(jte)
    txe, _ = tfl.markers(tte)
    jm, tm = jfl.FlowLensModel(K, rounds=6), tfl.FlowLensModel(K, rounds=6)
    jm.fit(jx, jy)
    tm.fit(tx, ty)
    for jr, tr in zip(jm.trees, tm.trees):
        for a, b in zip(jr, tr):
            assert_same((a.feature, a.threshold, a.value),
                        (b.feature, b.threshold, b.value))
    assert_same(jm.predict(jxe), tm.predict(txe))


# -- Leo and NetBeacon --------------------------------------------------------


def test_leo_predictions_match(flows):
    (jtr, jte), (ttr, tte) = flows
    jm, tm = jleo.LeoModel(K), tleo.LeoModel(K, device="cpu")
    jm.fit(jtr)
    tm.fit(ttr)
    assert_same(jm.arrs, tm.arrs)
    jr, tr = jm.predict_packets(jte), tm.predict_packets(tte)
    assert_same(jr, tr)


def test_netbeacon_predictions_match(flows):
    (jtr, jte), (ttr, tte) = flows
    jm = jnb.NetBeaconModel(K, seed=3)
    tm = tnb.NetBeaconModel(K, seed=3, device="cpu")
    jm.fit(jtr)
    tm.fit(ttr)
    for jf, tf in zip(jm.phase_forests, tm.phase_forests):
        assert_same(jf, tf)
    assert_same(jm.predict_packets(jte), tm.predict_packets(tte))


def test_netbeacon_vote_ties_go_to_the_lowest_class(monkeypatch):
    """Three trees voting three different classes (three-way ties), a
    two-against-one vote, and unanimity: the port's one-hot vote ==
    the reference's ``_forest_predict`` (its ``bincount(...).argmax()``
    row by row, on trees whose votes are given)."""
    votes = np.array([[5, 1, 2, 4, 0, 6],
                      [3, 1, 6, 4, 6, 6],
                      [0, 2, 4, 1, 6, 6]], np.int32)
    monkeypatch.setattr(jnb, "predict",
                        lambda tree, x, depth: jnp.asarray(votes[tree]))
    want = jnb.NetBeaconModel(K)._forest_predict(
        [0, 1, 2], np.zeros((votes.shape[1], 7)))
    assert list(want) == [0, 1, 2, 4, 6, 6]
    got = tnb.forest_vote(torch.from_numpy(votes), K)
    assert got.dtype == torch.int32
    assert_same(want, got)


# -- each scheme beats chance on the port (tests/test_baselines.py's margins)


def test_port_leo_and_netbeacon_beat_chance(flows):
    _, (tr, te) = flows
    for m in (tleo.LeoModel(K, device="cpu"),
              tnb.NetBeaconModel(K, device="cpu")):
        m.fit(tr)
        r = m.predict_packets(te)
        f1 = macro_f1(r["label"], r["pred"], K)
        assert f1 > CHANCE * 1.5, (type(m).__name__, f1)


def test_port_flowlens_beats_chance(flows):
    _, (tr, te) = flows
    x, y = tfl.markers(tr)
    xe, ye = tfl.markers(te)
    m = tfl.FlowLensModel(K, rounds=10)
    m.fit(x, y)
    f1 = macro_f1(ye, m.predict(xe), K)
    assert f1 > CHANCE * 2, f1


def _port_train(loss, params, x, y, steps=120):
    t = ttrainer.Trainer(loss, params, ttrainer.TrainerConfig(
        total_steps=steps, log_every=10**9,
        opt=topt.OptConfig(lr=3e-3, warmup_steps=12, total_steps=steps)),
        device="cpu")
    t.run(ttrainer.batch_iterator(x, y, 128, device="cpu"))
    return t.params


def test_port_bos_beats_chance(flows):
    _, (tr, te) = flows
    xtr, ytr, _ = tst.windows_from_flows(tr)
    xte, yte, _ = tst.windows_from_flows(te)
    cfg = tfenix_cnn(K)
    params = _port_train(lambda p, b: tbos.loss_fn(p, cfg, b),
                         tbos.init(cfg, 0, device="cpu"), xtr, ytr)
    pred = torch.argmax(tbos.apply(params, cfg, torch.from_numpy(xte)),
                        -1).numpy()
    f1 = macro_f1(yte, pred, K)
    assert f1 > CHANCE * 1.5, f1


def test_port_n3ic_beats_chance(flows):
    _, (tr, te) = flows
    x, y, _ = tn3ic.build_features(tr)
    xe, ye, _ = tn3ic.build_features(te)
    params = _port_train(tn3ic.loss_fn,
                         tn3ic.init(x.shape[1], K, 0, device="cpu"), x, y)
    pred = torch.argmax(tn3ic.apply(params, torch.from_numpy(xe)),
                        -1).numpy()
    f1 = macro_f1(ye, pred, K)
    assert f1 > CHANCE * 1.5, f1
