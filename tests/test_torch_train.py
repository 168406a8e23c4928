"""The port's training slice against the reference on the CPU: the float
traffic models (init, forward, loss and gradients), the AdamW optimizer
and its schedule, the fault-tolerant trainer (the first 20 losses from
the same init and batches), checkpoints readable both ways, NaN
recovery, resume, keep-k and gradient compression.  Tiny models, a few
steps; every tolerance is stated where it is used.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_close, assert_same  # noqa: E402
from repro.configs import fenix_models as jcfgs  # noqa: E402
from repro.data.synthetic_traffic import (class_weights,  # noqa: E402
                                          make_flows, windows_from_flows)
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import traffic as jtraffic  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import fenix_models as tcfgs  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.models import traffic as ttraffic  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

MODELS = ["fenix_cnn_tiny", "fenix_rnn_tiny"]


def _cfgs(name):
    return getattr(jcfgs, name)(), getattr(tcfgs, name)()


@pytest.fixture(scope="module")
def windows():
    x, y, _ = windows_from_flows(make_flows("iscx", 60, seed=3))
    return x, y, class_weights(y, 7)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _batches(x, y, w, lo=0, n=256):
    sl = slice(lo, lo + n)
    jb = {"payload": jnp.asarray(x[sl]), "label": jnp.asarray(y[sl]),
          "weight": jnp.asarray(w[sl], jnp.float32)}
    tb = {"payload": torch.from_numpy(x[sl]), "label": torch.from_numpy(
        y[sl]), "weight": torch.from_numpy(w[sl].astype(np.float32))}
    return jb, tb


# -- the float model -----------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("seed", [0, 7])
def test_init_is_bit_identical(name, seed):
    """Both sides cast the same float64 numpy draw to float32."""
    jc, tc = _cfgs(name)
    ref = _np(jtraffic.init(jc, seed))
    port = ttraffic.init(tc, seed, device="cpu")
    assert_same(ref, port)
    assert all(v.dtype == torch.float32 for v in port.values())


@pytest.mark.parametrize("name", MODELS)
def test_apply_loss_and_grads_match_reference(name, windows):
    """Logits within 1e-5 of the largest logit; the loss within 1e-5
    relative; each gradient within 1e-5 of its leaf's largest gradient.
    Both are float32 with the same ops in another summation order (XLA's
    dot against PyTorch's GEMM, im2col's einsum): the gaps measured here
    are <= 1e-6 of those scales."""
    x, y, w = windows
    jc, tc = _cfgs(name)
    jp = jtraffic.init(jc, 1)
    tp = ttraffic.init(tc, 1, device="cpu")
    jb, tb = _batches(x, y, w)
    assert_close(jtraffic.apply(jp, jc, jb["payload"]),
                 ttraffic.apply(tp, tc, tb["payload"]), 1e-5, "logits")
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtraffic.loss_fn(p, jc, jb), has_aux=True)(jp)
    tl, taux, tg = topt.value_and_grad(
        lambda p, b: ttraffic.loss_fn(p, tc, b), tp, tb)
    assert_close(jl, tl, 1e-5, "loss")
    assert float(jaux["acc"]) == float(taux["acc"])
    for k in jg:
        assert_close(jg[k], tg[k], 1e-5, f"grad {k}")


# -- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_lr_matches_reference(schedule):
    """float32 on both sides; cos may round differently in its last bit,
    so 1e-6 relative."""
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    for step in range(0, 45):
        ref = float(jopt.schedule_lr(jc, jnp.asarray(step, jnp.int32)))
        port = float(topt.schedule_lr(tc, torch.tensor(step,
                                                       dtype=torch.int32)))
        assert port == pytest.approx(ref, rel=1e-6, abs=0), step


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_reference(clip):
    """Three AdamW steps on the same params and gradients (1-d params
    skip weight decay; the first step's gradients are large enough to
    clip): params, moments, grad_norm and lr within 1e-6 of each leaf's
    largest magnitude (float32 elementwise ops; pow and sqrt may round
    differently in their last bit)."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "k": (3, 4, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=clip)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    for i in range(3):
        g = {k: rng.normal(0, 3.0 / (i + 1), s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = jopt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc)
        tp, ts, tm = topt.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tc)
        for k in shapes:
            assert_close(jp[k], tp[k], 1e-6, f"step {i} param {k}")
            assert_close(js["m"][k], ts["m"][k], 1e-6, f"step {i} m {k}")
            assert_close(js["v"][k], ts["v"][k], 1e-6, f"step {i} v {k}")
        assert int(js["step"]) == int(ts["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_make_train_step_is_functional(windows):
    """The reference's make_train_step: a new (params, state) and the
    metrics; the inputs are left as they were."""
    x, y, w = windows
    tc = tcfgs.fenix_cnn_tiny()
    tp = ttraffic.init(tc, 0, device="cpu")
    before = {k: v.clone() for k, v in tp.items()}
    step = topt.make_train_step(lambda p, b: ttraffic.loss_fn(p, tc, b),
                                topt.OptConfig(lr=1e-2, warmup_steps=0))
    _, tb = _batches(x, y, w)
    new_p, new_s, m = step(tp, topt.init_state(tp), tb)
    assert sorted(m) == ["acc", "grad_norm", "loss", "lr"]
    assert int(new_s["step"]) == 1
    assert_same(before, tp)
    assert any(not torch.equal(new_p[k], tp[k]) for k in tp)


# -- the trainer ---------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_trainer_losses_match_reference(name, windows):
    """The reference's Trainer and the port's (eager, CPU) from the same
    init over the same batches (batch_iterator's draws from one seed):
    the first 20 losses within 1e-4 relative.  Measured: <= 2.2e-7
    relative (2.4e-7 absolute), float32 summation order only."""
    x, y, w = windows
    jc, tc = _cfgs(name)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20, weight_decay=0.01)
    ref = jtrainer.Trainer(lambda p, b: jtraffic.loss_fn(p, jc, b),
                           jtraffic.init(jc, 0),
                           jtrainer.TrainerConfig(total_steps=20, log_every=1,
                                                  opt=jopt.OptConfig(**kw)))
    ref.run(jtrainer.batch_iterator(x, y, 256, seed=1, weights=w))
    port = ttrainer.Trainer(lambda p, b: ttraffic.loss_fn(p, tc, b),
                            ttraffic.init(tc, 0, device="cpu"),
                            ttrainer.TrainerConfig(total_steps=20,
                                                   log_every=1,
                                                   opt=topt.OptConfig(**kw)),
                            device="cpu")
    assert port.step_backend == "eager"
    port.run(ttrainer.batch_iterator(x, y, 256, seed=1, weights=w,
                                     device="cpu"))
    rl = np.array([m["loss"] for m in ref.metrics_log])
    pl = np.array([m["loss"] for m in port.metrics_log])
    assert len(rl) == len(pl) == 20
    np.testing.assert_allclose(pl, rl, rtol=1e-4, atol=0)
    assert [m["acc"] for m in port.metrics_log] == \
        [m["acc"] for m in ref.metrics_log]


def test_batch_iterator_draws_the_reference_batches():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1000, (50, 9, 2)).astype(np.int32)
    y = rng.integers(0, 7, 50).astype(np.int32)
    w = rng.random(50)
    ref = jtrainer.batch_iterator(x, y, 16, seed=3, weights=w)
    port = ttrainer.batch_iterator(x, y, 16, seed=3, weights=w,
                                   device="cpu")
    for _ in range(4):
        rb, idx = next(ref), next(port)["index"]
        for k, v in rb.items():
            assert_same(v, port.data[k][torch.from_numpy(idx)], k)


def _toy_params(rng):
    return {"w": rng.normal(0, 1, (8, 8)).astype(np.float32),
            "b": rng.normal(0, 1, (8,)).astype(np.float32)}


def _toy_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _toy_cfg(ckpt_dir=None, steps=20, **kw):
    return ttrainer.TrainerConfig(
        total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5, log_every=100,
        opt=topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=steps,
                           weight_decay=0.0), **kw)


def test_trainer_recovers_from_nan(tmp_path):
    """As the reference's test_trainer_recovers_from_nan: a poisoned batch
    after the first checkpoint restores it and the run still ends at its
    step count with finite params."""
    rng = np.random.default_rng(0)
    t = ttrainer.Trainer(_toy_loss, _toy_params(rng), _toy_cfg(
        str(tmp_path)), device="cpu")

    def batches():
        i = 0
        while True:
            i += 1
            x = rng.normal(0, 1, (4, 8)).astype(np.float32)
            y = np.zeros((4, 8), np.float32)
            if i == 8:  # one poisoned batch after the first checkpoint
                y = y * np.nan
            yield {"x": x, "y": y}

    t.run(batches())
    assert t.step == 20
    assert t.recoveries == 1
    assert bool(torch.all(torch.isfinite(t.params["w"])))


def test_nan_step_leaves_the_state_unchanged(windows):
    """With no checkpoint a NaN batch is skipped: the update is selected
    on the device by isfinite(loss), so params, moments and the counter
    after the NaN step are those before it."""
    x, y, w = windows
    tc = tcfgs.fenix_rnn_tiny()
    t = ttrainer.Trainer(lambda p, b: ttraffic.loss_fn(p, tc, b),
                         ttraffic.init(tc, 0, device="cpu"),
                         _toy_cfg(steps=3), device="cpu")
    batches = ttrainer.batch_iterator(x, y, 64, seed=0, weights=w,
                                      device="cpu")
    t.run(batches)
    before = {"p": {k: v.clone() for k, v in t.params.items()},
              "m": {k: v.clone() for k, v in t.opt_state["m"].items()},
              "v": {k: v.clone() for k, v in t.opt_state["v"].items()},
              "step": t.opt_state["step"].clone()}
    saved = batches.data["weight"].clone()
    batches.data["weight"].fill_(float("nan"))
    values = t._train_step(batches, next(batches)).tolist()
    assert np.isnan(dict(zip(t._names, values))["loss"])
    assert_same(before, {"p": t.params, "m": t.opt_state["m"],
                         "v": t.opt_state["v"],
                         "step": t.opt_state["step"]})
    batches.data["weight"].copy_(saved)
    t.run(batches, steps=1)
    assert t.step == 4 and int(t.opt_state["step"]) == 4


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    """A new trainer on the same ckpt_dir resumes at the last step with
    the saved params and optimizer state; keep-k holds."""
    rng = np.random.default_rng(1)
    params = _toy_params(rng)
    cfg = _toy_cfg(str(tmp_path), steps=12, keep=2)
    t = ttrainer.Trainer(_toy_loss, params, cfg, device="cpu")

    def batches():
        while True:
            yield {"x": rng.normal(0, 1, (4, 8)).astype(np.float32),
                   "y": np.zeros((4, 8), np.float32)}

    t.run(batches())
    assert tckpt.list_steps(str(tmp_path)) == [10, 12]
    t2 = ttrainer.Trainer(_toy_loss, params, cfg, device="cpu")
    assert t2.step == 12
    assert_same(t.params, t2.params)
    assert_same(t.opt_state, t2.opt_state)
    t2.run(batches(), steps=3)
    assert t2.step == 15 and int(t2.opt_state["step"]) == 15


def test_trainer_takes_a_new_batch_shape():
    """A batch of another shape gets new step buffers (the reference's
    jit retraces), and training goes on from the same params."""
    rng = np.random.default_rng(3)
    t = ttrainer.Trainer(_toy_loss, _toy_params(rng), _toy_cfg(steps=2),
                         device="cpu")

    def batches(n):
        while True:
            yield {"x": rng.normal(0, 1, (n, 8)).astype(np.float32),
                   "y": np.zeros((n, 8), np.float32)}

    t.run(batches(4))
    w = t.params["w"]
    t.run(batches(6), steps=2)
    assert t.step == 4 and t.params["w"] is w
    assert t._bufs["batch"]["x"].shape == (6, 8)


def test_graph_step_backend_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ttrainer.Trainer(_toy_loss, _toy_params(np.random.default_rng(0)),
                         _toy_cfg(step_backend="graph"), device="cpu")
    with pytest.raises(ValueError, match="unknown step_backend"):
        ttrainer.TrainerConfig(step_backend="jit")


def test_training_entry_points_need_cuda_unless_cpu(monkeypatch, windows):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, w = windows
    with pytest.raises(RuntimeError, match="CUDA"):
        ttraffic.init(tcfgs.fenix_cnn_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(_toy_loss, _toy_params(np.random.default_rng(0)),
                         _toy_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.batch_iterator(x, y, 8)


# -- checkpoints ---------------------------------------------------------------


def test_checkpoints_are_readable_both_ways(tmp_path):
    """The port's checkpoint restores through the reference's reader and
    the reference's through the port's: the same keys, dtypes and
    values, the same step and meta."""
    rng = np.random.default_rng(0)
    p = _toy_params(rng)
    state = {"params": {k: torch.from_numpy(v) for k, v in p.items()},
             "opt": {"step": torch.tensor(3, dtype=torch.int32),
                     "m": {"w": torch.zeros(8, 8)}}}
    tckpt.save(str(tmp_path / "port"), 3, state, meta={"note": "port"})
    ref_tree, ref_meta = jckpt.restore_latest(str(tmp_path / "port"))
    assert ref_meta["step"] == 3 and ref_meta["note"] == "port"
    assert_same(state, jax.tree.map(np.asarray, ref_tree))
    assert np.asarray(ref_tree["opt"]["step"]).dtype == np.int32

    jstate = {"params": {k: jnp.asarray(v) for k, v in p.items()},
              "opt": {"step": jnp.asarray(5, jnp.int32)}}
    jckpt.save(str(tmp_path / "ref"), 5, jstate, meta={"note": "ref"})
    tree, meta = tckpt.restore_latest(str(tmp_path / "ref"))
    assert meta["step"] == 5 and meta["note"] == "ref"
    assert_same(jax.tree.map(np.asarray, jstate), tree)
    assert tree["params"]["w"].dtype == np.float32


def test_checkpoint_keep_k_and_incomplete_steps(tmp_path):
    rng = np.random.default_rng(0)
    for step in range(1, 6):
        tckpt.save(str(tmp_path), step, {"p": _toy_params(rng)}, keep=2)
    assert tckpt.list_steps(str(tmp_path)) == [4, 5]
    # a crashed writer: a directory without the COMPLETE sentinel
    os.makedirs(tmp_path / "step_00000009")
    assert tckpt.list_steps(str(tmp_path)) == [4, 5]
    assert tckpt.restore_latest(str(tmp_path))[1]["step"] == 5
    assert tckpt.restore_latest(str(tmp_path / "none")) is None


def test_async_checkpointer(tmp_path):
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    p = {k: torch.from_numpy(v) for k, v in
         _toy_params(np.random.default_rng(0)).items()}
    ac.save(7, {"p": p})
    p["w"].zero_()                    # read back before save returned
    ac.wait()
    assert tckpt.list_steps(str(tmp_path)) == [7]
    assert np.abs(tckpt.restore(str(tmp_path), 7)[0]["p"]["w"]).sum() > 0


# -- gradient compression ------------------------------------------------------


def test_compression_matches_reference():
    """quantize -> dequantize with error feedback, five rounds: int8
    codes equal; the scale, gradients and residuals float32 within 1e-6
    relative (one division and one multiply in another order)."""
    rng = np.random.default_rng(0)
    g0 = rng.normal(0, 1, (64, 64)).astype(np.float32)
    jq, js = jcomp.quantize_grad(jnp.asarray(g0))
    tq, ts = tcomp.quantize_grad(torch.from_numpy(g0))
    assert_same(jq, tq)
    assert float(ts) == pytest.approx(float(js), rel=1e-6)
    shapes = {"w": (16, 16), "b": (16,)}
    jst = jcomp.CompressedState.init({k: jnp.zeros(s) for k, s in
                                      shapes.items()})
    tst = tcomp.CompressedState.init({k: torch.zeros(s) for k, s in
                                      shapes.items()})
    for i in range(5):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()}
        jg, jst = jcomp.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jst)
        tg, tst = tcomp.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        for k in shapes:
            assert_close(jg[k], tg[k], 1e-6, f"round {i} grad {k}")
            assert_close(jst.error[k], tst.error[k], 1e-6,
                         f"round {i} error {k}")


def test_compressed_training_converges():
    """As the reference's test: int8 error-feedback compression on the
    train step still fits a linear model."""
    rng = np.random.default_rng(2)
    w_true = rng.normal(0, 1, (8, 1)).astype(np.float32)

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2), {}

    def batches():
        while True:
            x = rng.normal(0, 1, (32, 8)).astype(np.float32)
            yield {"x": x, "y": x @ w_true}

    cfg = ttrainer.TrainerConfig(
        total_steps=400, grad_compression=True, log_every=10**9,
        opt=topt.OptConfig(lr=5e-2, warmup_steps=0, total_steps=400,
                           weight_decay=0.0, schedule="constant"))
    t = ttrainer.Trainer(loss_fn, {"w": np.zeros((8, 1), np.float32)}, cfg,
                         device="cpu")
    m = t.run(batches())
    assert m["loss"] < 5e-2, m["loss"]
    assert float(torch.abs(t.comp_state.error["w"]).sum()) > 0
