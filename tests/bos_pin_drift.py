"""BoS at the Table-2 pin's settings (250 flows, 150 steps), the
reference against the port on the CPU, with the port's gate activations
swapped: where does the port's macro-F1 leave the pinned value?

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/bos_pin_drift.py ustc

Prints how often each activation agrees bit for bit with JAX's on BoS's
own gate inputs, then, for each variant, the initial logits, the step at
which the training losses first differ from the reference's by more than
1e-5 and 1e-3 relative, the test macro-F1 and the share of equal test
predictions.  The variants: the port as it is (``layers.sigmoid``, torch's
``tanh``); ``torch.sigmoid``; and XLA's CPU ``tanh`` (the rational
approximation with fused multiply-adds, reproduced here bit for bit)
with ``lax.logistic``'s formula (on torch's ``exp``), each with JAX's
derivative rule.  A diagnostic, not a test: pytest does not collect it.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks.bench_accuracy import _split_flows
from repro.baselines import bos as jbos
from repro.baselines.common import macro_f1
from repro.configs.fenix_models import fenix_cnn as jcnn
from repro.data import synthetic_traffic as jst
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch.baselines import bos as tbos
from repro_torch.configs.fenix_models import fenix_cnn as tcnn
from repro_torch.models import layers
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttr

# XLA's CPU tanh: x p(x^2) / q(x^2) on x clamped to +-7.99881172180175781,
# x itself below 0.0004, the polynomials in fused multiply-adds
_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
        5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
        4.89352455891786e-03)
_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
        4.89352518554385e-03)


def _horner(coeffs, x2):
    acc = torch.full_like(x2, coeffs[0])
    for c in coeffs[1:]:    # a float32 fma: the float64 product is exact
        acc = (acc.double() * x2.double()
               + torch.tensor(c, dtype=torch.float32).double()).float()
    return acc


def xla_tanh_fwd(x):
    xc = torch.clamp(x, -7.99881172180175781, 7.99881172180175781)
    x2 = xc * xc
    return torch.where(x.abs() < 0.0004, x,
                       xc * _horner(_NUM, x2) / _horner(_DEN, x2))


class Logistic(torch.autograd.Function):
    """lax.logistic: 1 / (1 + exp(-x)); derivative g (y (1 - y))."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


class XlaTanh(torch.autograd.Function):
    """XLA's CPU tanh; JAX's derivative g (4 (logistic(2x) logistic(-2x)))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return xla_tanh_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (4 * (Logistic.apply(2 * x) * Logistic.apply(-2 * x)))


def _swapped(sigmoid, tanh, fn):
    """fn() with BoS's gates on ``sigmoid`` and ``tanh``."""
    saved = tbos.sigmoid, torch.tanh
    tbos.sigmoid, torch.tanh = sigmoid, tanh
    try:
        return fn()
    finally:
        tbos.sigmoid, torch.tanh = saved


def main(task):
    k = len(jst.task_meta(task)[0])
    steps = 150
    tr, te = _split_flows(jst.make_flows(task, 250, seed=0,
                                         min_per_class=30), seed=0)
    xtr, ytr, _ = jst.windows_from_flows(tr, seed=0)
    xte, yte, _ = jst.windows_from_flows(te, seed=1)
    w = jst.class_weights(ytr, k)
    kw = dict(lr=3e-3, warmup_steps=steps // 10, total_steps=steps,
              weight_decay=0.01)
    jc, tc = jcnn(k), tcnn(k)
    ref = jtr.Trainer(lambda p, b: jbos.loss_fn(p, jc, b), jbos.init(jc, 0),
                      jtr.TrainerConfig(total_steps=steps, log_every=1,
                                        opt=jopt.OptConfig(**kw)))
    ref.run(jtr.batch_iterator(xtr, ytr, 256, seed=0, weights=w))
    rl = np.array([m["loss"] for m in ref.metrics_log])
    jpred = np.asarray(jnp.argmax(jbos.apply(ref.params, jc,
                                             jnp.asarray(xte)), -1))
    jl0 = np.asarray(jbos.apply(jbos.init(jc, 0), jc, jnp.asarray(xte)))
    print(f"{task}: reference macro-F1 {macro_f1(yte, jpred, k):.4f}")

    seen = {"sigmoid": [], "tanh": []}

    def rec(name, f):
        return lambda x: (seen[name].append(x.detach().clone()), f(x))[1]

    p0 = tbos.init(tc, 0, device="cpu")
    _swapped(rec("sigmoid", layers.sigmoid), rec("tanh", torch.tanh),
             lambda: tbos.apply(p0, tc, torch.from_numpy(xte)))
    for name, jf, fs in (
            ("sigmoid", jax.nn.sigmoid,
             (("layers.sigmoid", layers.sigmoid),
              ("torch.sigmoid", torch.sigmoid))),
            ("tanh", jnp.tanh, (("torch.tanh", torch.tanh),
                                ("XLA's CPU tanh", xla_tanh_fwd)))):
        x = torch.cat([t.reshape(-1) for t in seen[name]])
        want = np.asarray(jax.jit(jf)(x.numpy()))
        for fname, f in fs:
            same = np.mean(f(x).numpy() == want)
            print(f"  {fname} == JAX's {name} on {same:.4f} of BoS's "
                  f"{x.numel()} gate inputs at init")

    for name, sig, tanh in (
            ("port (layers.sigmoid, torch.tanh)", layers.sigmoid,
             torch.tanh),
            ("torch.sigmoid, torch.tanh", torch.sigmoid, torch.tanh),
            ("XLA's tanh, lax.logistic, JAX's derivatives", Logistic.apply,
             XlaTanh.apply)):
        def run():
            tl0 = tbos.apply(tbos.init(tc, 0, device="cpu"), tc,
                             torch.from_numpy(xte)).detach().numpy()
            t = ttr.Trainer(lambda p, b: tbos.loss_fn(p, tc, b),
                            tbos.init(tc, 0, device="cpu"),
                            ttr.TrainerConfig(total_steps=steps, log_every=1,
                                              opt=topt.OptConfig(**kw)),
                            device="cpu")
            t.run(ttr.batch_iterator(xtr, ytr, 256, seed=0, weights=w,
                                     device="cpu"))
            with torch.no_grad():
                pred = torch.argmax(tbos.apply(t.params, tc,
                                               torch.from_numpy(xte)), -1)
            return tl0, [m["loss"] for m in t.metrics_log], pred.numpy()

        tl0, pl, pred = _swapped(sig, tanh, run)
        rel = np.abs(np.array(pl) - rl) / np.abs(rl)
        first = [int(np.argmax(rel > t)) if (rel > t).any() else None
                 for t in (0, 1e-5, 1e-3)]
        print(f"  {name}: initial logits equal on {np.mean(tl0 == jl0):.4f},"
              f" max|diff| {np.abs(tl0 - jl0).max():.3g}; losses first "
              f"differ / over 1e-5 / over 1e-3 relative at step {first}, "
              f"largest {rel.max():.3g}; macro-F1 "
              f"{macro_f1(yte, pred, k):.4f}, test predictions equal on "
              f"{np.mean(pred == jpred):.4f}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ustc")
