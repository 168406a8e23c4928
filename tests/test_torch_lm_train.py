"""The port's LM training path against the JAX package on the CPU:
``api.loss_fn`` and its gradients for every family and attention
variant, the remat policies, ``softmax_xent``, the MoE's gradients at a
capacity that drops pairs, AdamW steps of the port's ``Trainer``
against the reference's jitted train step, the launcher's token stream,
the API's specs and FLOP counts, and the launcher's checkpoint/restart.

Every model runs on its ``reduced()`` config switched to float32, with
the reference's weights carried across by ``params_from_numpy``, on a
batch of 2 x 40 tokens drawn from a seed (the encdec's source and the
vlm's image are float32 normals from the same seed).  Tolerances:

- the loss within 1e-5 relative, every metric within 1e-5 of the
  loss's magnitude: the same float32 operations, summed in another
  order (measured at most 1.5e-7);
- each gradient leaf within 1e-4 of that leaf's largest magnitude: the
  backward's products and sums in another order, through up to five
  layers (measured at most 1.2e-5, recurrentgemma's RG-LRU scan; the
  transformer, ssm, encdec and vlm families at most 3.3e-6).

The reference's JAX gradient of each variant is compiled once, and the
module's JAX work takes about a minute.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_same
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import layers as JL
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import train as ttrain
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.models import mamba2, transformer
from repro_torch.models.param import associative_scan, params_from_numpy
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

F32_OVER = dict(param_dtype="float32", activation_dtype="float32")
B, S = 2, 40
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

# variant -> (arch, config overrides, vlm gate value or None)
VARIANTS = {
    "gqa": ("llama3.2-1b", {}, None),
    "moe": ("qwen2-moe-a2.7b", {}, None),
    # capacity t * k: no (token, choice) pair is dropped
    "moe-nodrop": ("qwen2-moe-a2.7b", {"capacity_factor": 8.0}, None),
    "mla": ("deepseek-v2-236b", {}, None),
    "ssm": ("mamba2-370m", {}, None),
    "hybrid": ("recurrentgemma-9b", {}, None),
    "encdec": ("seamless-m4t-medium", {}, None),
    "vlm": ("llama-3.2-vision-11b", {}, 0.5),
    # the reference's init: at gates 0 the cross layers are the identity
    "vlm-gate0": ("llama-3.2-vision-11b", {}, 0.0),
}


def _cfgs(arch, moe_over=None, **over):
    cj = dataclasses.replace(jax_config(arch, reduced=True), **F32_OVER,
                             **over)
    ct = dataclasses.replace(get_config(arch, reduced=True), **F32_OVER,
                             **over)
    if moe_over:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe,
                                                             **moe_over))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe,
                                                             **moe_over))
    return cj, ct


def _batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(0, 1, (B, 24, cfg.d_model)
                                         ).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            0, 1, (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _set_gates(jp, gate):
    return {k: (jnp.full_like(v, gate) if k.endswith(("gate_attn",
                                                      "gate_mlp")) else v)
            for k, v in jp.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(ct, tp, batch):
    return topt.value_and_grad(lambda p, b: api.loss_fn(p, ct, b), tp,
                               _torch_batch(batch))


@pytest.fixture(scope="module")
def variant_runs():
    """variant -> (cfgs, the port's params, batch, the reference's (loss,
    metrics, grads)), each JAX gradient compiled once."""
    cache = {}

    def get(name):
        if name not in cache:
            arch, moe_over, gate = VARIANTS[name]
            cj, ct = _cfgs(arch, moe_over)
            jp, _ = japi.init_params(cj, seed=0)
            if gate is not None:
                jp = _set_gates(jp, gate)
            tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   "cpu")
            batch = _batch(cj, mask=name == "gqa")
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p, b: japi.loss_fn(p, cj, b), has_aux=True))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[name] = ((cj, ct), tp, batch, (loss, metrics, grads))
        return cache[name]

    return get


# -- api.loss_fn and its gradients --------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_and_grads_match_reference(name, variant_runs):
    """``api.loss_fn``'s loss, metrics and every gradient leaf against
    ``jax.value_and_grad(api.loss_fn)`` (tolerances in the module
    docstring); the port's gradients cover the reference's leaves."""
    (cj, ct), tp, batch, (jl, jm, jg) = variant_runs(name)
    loss, metrics, grads = _port_grads(ct, tp, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl)), \
        (float(loss), float(jl))
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= \
            LOSS_TOL * abs(float(jl)), (k, float(metrics[k]), float(jm[k]))
    assert sorted(grads) == sorted(jg)
    for k in jg:
        assert grads[k].dtype == tp[k].dtype, k
        assert_close(jg[k], grads[k], GRAD_TOL, f"{name} grad {k}")


def test_moe_variants_drop_and_do_not(variant_runs):
    """The MoE cases are what they claim: at the config's capacity
    factor pairs are dropped (and the aux loss is in the loss), at a
    factor of e (capacity t * k) none is.  Counted on the port's routing
    of the first MoE layer."""
    for name, want_drops in (("moe", True), ("moe-nodrop", False)):
        (cj, ct), tp, batch, (jl, jm, _) = variant_runs(name)
        assert float(jm["moe_aux"]) > 0
        x = transformer._embed_in(tp, ct, torch.from_numpy(batch["tokens"]))
        p0 = {k[len("layers/"):]: v[0] for k, v in tp.items()
              if k.startswith("layers/")}
        h = TL.rmsnorm(p0, "ln_mlp", x + transformer._attn_seq(
            p0, ct, TL.rmsnorm(p0, "ln_attn", x, ct.norm_eps))[0],
            ct.norm_eps)
        logits = TL.einsum("td,de->te", h.reshape(-1, ct.d_model),
                           p0["moe/router/w"])
        _, top_i = TL._top_k(torch.softmax(logits, -1), ct.moe.top_k)
        t = B * S
        cap = max(1, int(ct.moe.capacity_factor * t * ct.moe.top_k
                         / ct.moe.num_experts))
        counts = torch.bincount(top_i.reshape(-1),
                                minlength=ct.moe.num_experts)
        assert bool((counts > cap).any()) == want_drops, (name, counts, cap)


def test_vlm_gates_at_zero_pass_no_gradient_to_the_cross_layers(
        variant_runs):
    """At the reference's init (gates 0) every cross-attention and
    cross-MLP weight has a zero gradient on both sides while the gates'
    own gradients are not zero; at gates 0.5 they are not zero."""
    for name, zero in (("vlm-gate0", True), ("vlm", False)):
        (_, ct), tp, batch, (_, _, jg) = variant_runs(name)
        _, _, grads = _port_grads(ct, tp, batch)
        for k in grads:
            if not k.startswith("sb/cross/") or k.endswith("/scale"):
                continue
            if k.endswith(("gate_attn", "gate_mlp")):
                assert float(grads[k].abs().max()) > 0, (name, k)
                continue
            assert (float(grads[k].abs().max()) == 0) == zero, (name, k)
            assert (float(np.abs(np.asarray(jg[k])).max()) == 0) == zero, \
                (name, k)


# -- remat --------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted({a for a, _, _ in VARIANTS.values()}))
def test_remat_policies_agree_bit_for_bit(arch, monkeypatch):
    """"none", "nothing" and "dots" give the same loss, metrics and
    gradients bit for bit (the recomputation repeats the same ops); under
    "dots" the policy keeps the weight GEMMs (einsum's ``bmm`` over a
    batch of 1) and no batched product."""
    seen = []
    save_dots = transformer._save_dots

    def recording(ctx, op, *args, **kwargs):
        out = save_dots(ctx, op, *args, **kwargs)
        seen.append((op, out))
        return out

    monkeypatch.setattr(transformer, "_save_dots", recording)
    out = {}
    for pol in ("none", "nothing", "dots"):
        _, ct = _cfgs(arch, remat_policy=pol)
        tp, _ = api.init_params(ct, seed=0, device="cpu")
        out[pol] = _port_grads(ct, tp, _batch(ct))
    for pol in ("nothing", "dots"):
        assert_same(out["none"][0], out[pol][0], pol)
        assert_same(out["none"][1], out[pol][1], pol)
        assert_same(out["none"][2], out[pol][2], pol)
    saved = {str(op) for op, pol in seen
             if pol == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert saved and saved <= {"aten.bmm.default", "aten.mm.default",
                               "aten.mm.dtype"}, saved
    assert any(str(op) == "aten.bmm.default" and pol !=
               torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
               for op, pol in seen), "no batched product recomputed"


# -- layers -------------------------------------------------------------------


def test_softmax_xent_matches_reference():
    """Mean and masked-mean cross-entropy (an all-zero mask divides by
    1), values and logit gradients within 1e-6 of the largest."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(0, 4, (3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for mask in (None, (rng.random((3, 7)) < 0.5).astype(np.float32),
                 np.zeros((3, 7), np.float32)):
        jv, jg = jax.value_and_grad(lambda lg: JL.softmax_xent(
            lg, jnp.asarray(labels), None if mask is None
            else jnp.asarray(mask)))(jnp.asarray(logits))
        tl = torch.from_numpy(logits).requires_grad_()
        tv = TL.softmax_xent(tl, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
        tv.backward()
        assert_close(jv, tv.detach(), 1e-6, "value")
        assert_close(jg, tl.grad, 1e-6, "grad")


def test_moe_ffn_gradients_and_dropped_pairs():
    """``moe_ffn`` at capacity 1 (most pairs dropped), float32: y and the
    aux loss, and the gradients of sum(y * r) + aux for the input and
    every weight within 1e-5 of the reference's.  The gradient of sum(y
    * r) alone reaches exactly the tokens with a kept pair, on both sides
    (a dropped pair passes none: no shared experts here); the aux loss
    alone reaches the router through ``probs`` and no expert."""
    cj, ct = _cfgs("qwen2-moe-a2.7b", moe_over={
        "capacity_factor": 0.05, "num_shared_experts": 0, "shared_d_ff": 0,
        "shared_gated": False})
    jp, _ = japi.init_params(cj, seed=1)
    jp = {k[len("layers/"):]: v[0] for k, v in jp.items()
          if k.startswith("layers/moe/")}
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 12, cj.d_model)).astype(np.float32)
    r = rng.normal(0, 1, (2, 12, cj.d_model)).astype(np.float32)

    def jloss(p, xx, with_aux):
        y, aux = JL.moe_ffn(p, "moe", xx, cj.moe, cj.mlp_act)
        return jnp.sum(y * r) + (aux if with_aux else 0.0)

    def tgrads(with_y, with_aux):
        tx = torch.from_numpy(x).requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
        y, aux = TL.moe_ffn(leaves, "moe", tx, ct.moe, ct.mlp_act)
        loss = (torch.sum(y * torch.from_numpy(r)) if with_y else 0.0) \
            + (aux if with_aux else 0.0)
        loss.backward()
        return loss.detach(), tx.grad, {k: v.grad for k, v in leaves.items()}

    for with_aux in (True, False):
        jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jp, jnp.asarray(x), with_aux)
        tv, tgx, tgp = tgrads(True, with_aux)
        assert_close(jv, tv, 1e-5, "loss")
        assert_close(jgx, tgx, 1e-5, "x grad")
        for k in jgp:
            assert_close(jgp[k], tgp[k], 1e-5, k)
    # capacity 1 an expert: at most e of the 24 tokens keep a pair
    served = tgx.abs().sum(-1) > 0
    cap = max(1, int(ct.moe.capacity_factor * 24 * ct.moe.top_k
                     / ct.moe.num_experts))
    assert cap == 1 and 0 < int(served.sum()) <= ct.moe.num_experts
    assert_same(np.abs(np.asarray(jgx)).sum(-1) > 0, served, "served")
    _, gx, gp = tgrads(False, True)
    assert float(gp["moe/router/w"].abs().max()) > 0
    assert float(gx.abs().max()) > 0
    assert all(gp[k] is None for k in gp if "/experts/" in k)


def test_matmul_f32_backward_is_the_cast_path_s(monkeypatch):
    """``_MatmulF32`` (the card's bfloat16 head with a float32 result)
    differentiates as the CPU's ``a.float() @ b.float()`` does: its
    backward run here, with the forward's ``torch.mm(out_dtype=)`` (no
    CPU kernel) standing in as the cast product.  The operand gradients
    come back bfloat16 and equal the cast path's bit for bit."""
    mm = torch.mm

    def cast_mm(a, b, out_dtype=None):
        assert out_dtype == torch.float32
        return mm(a.float(), b.float())

    monkeypatch.setattr(torch, "mm", cast_mm)
    rng = np.random.default_rng(5)
    a0 = torch.from_numpy(rng.normal(0, 1, (6, 16)).astype(np.float32)
                          ).bfloat16()
    t0 = torch.from_numpy(rng.normal(0, 1, (30, 16)).astype(np.float32)
                          ).bfloat16()
    g = torch.from_numpy(rng.normal(0, 1, (6, 30)).astype(np.float32))
    a, t = a0.clone().requires_grad_(), t0.clone().requires_grad_()
    TL._MatmulF32.apply(a, t.t()).backward(g)
    a2, t2 = a0.clone().requires_grad_(), t0.clone().requires_grad_()
    torch.matmul(a2.float(), t2.t().float()).backward(g)
    assert a.grad.dtype == t.grad.dtype == torch.bfloat16
    assert_same(a.grad.float(), a2.grad.float(), "a")
    assert_same(t.grad.float(), t2.grad.float(), "table")


def test_gradient_paths_compute_the_serving_bits():
    """Where autograd records the inputs, the band attention (windowed
    and not, the first band padded), the chunked and kv-block attention
    and mamba2's chunked SSD run their in-place steps out of place: the
    forward values are the serving path's bit for bit, and the
    associative scan differentiates."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    q, k, v = rnd(2, 45, 4, 16), rnd(2, 45, 2, 16), rnd(2, 45, 2, 16)
    for impl, window in (("bands", None), ("bands", 20), ("chunked", None),
                         ("chunked", 20)):
        kw = dict(causal=True, impl=impl, chunk_q=16, chunk_kv=16,
                  window=window)
        want = TL.attention(q, k, v, **kw)
        got = TL.attention(q.clone().requires_grad_(), k, v, **kw)
        assert got.requires_grad
        assert_same(want, got.detach(), f"{impl} {window}")
    kx = rnd(2, 20, 2, 16)
    want = TL.attention(q, kx, kx, causal=False, impl="bands", chunk_kv=8)
    got = TL.attention(q.requires_grad_(), kx, kx, causal=False,
                       impl="bands", chunk_kv=8)
    assert_same(want, got.detach(), "kv blocks")

    _, ct = _cfgs("mamba2-370m")
    xdt, dA = rnd(2, 70, 1, 4, 16), -rnd(2, 70, 1, 4).abs()
    br, cr = rnd(2, 70, 1, 16), rnd(2, 70, 1, 16)
    h0 = rnd(2, 1, 4, 16, 16)
    want = mamba2._ssd_chunked(xdt, dA, br, cr, ct, h0=h0, diag_chunks=1)
    got = mamba2._ssd_chunked(xdt.requires_grad_(), dA, br, cr, ct, h0=h0,
                              diag_chunks=1)
    assert got[0].requires_grad and got[1].requires_grad
    assert_same(want, [t.detach() for t in got], "ssd")

    a = torch.rand(3, 11, generator=gen).requires_grad_()
    bb = rnd(3, 11).requires_grad_()
    _, h = associative_scan(lambda lf, rt: (lf[0] * rt[0],
                                            lf[1] * rt[0] + rt[1]),
                            (a, bb), axis=1)
    h.sum().backward()
    ref = [torch.zeros(3)]
    for i in range(11):
        ref.append(ref[-1] * a[:, i].detach() + bb[:, i].detach())
    assert_close(torch.stack(ref[1:], 1), h.detach(), 1e-6, "scan")
    assert a.grad is not None and bb.grad is not None


# -- the trainer --------------------------------------------------------------


def test_trainer_steps_match_reference_train_step():
    """Five AdamW steps of the port's ``Trainer`` (eager) on the reduced
    llama (float32) and the launcher's token stream against the
    reference's ``jax.jit(make_train_step(...))`` from the same init:
    each step's loss and gradient norm within 1e-5 relative.  (The
    params are not held to a tolerance: Adam divides each gradient by
    its own root mean square, so an element whose gradient is at the
    rounding level moves by up to the learning rate either way.)"""
    cj, ct = _cfgs("llama3.2-1b")
    ocfg_j = jopt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    ocfg_t = topt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    jp, _ = japi.init_params(cj, seed=0)
    state = jopt.init_state(jp)
    step = jax.jit(jopt.make_train_step(
        lambda p, b: japi.loss_fn(p, cj, b), ocfg_j))
    trainer = Trainer(lambda p, b: api.loss_fn(p, ct, b),
                      {k: np.asarray(v) for k, v in jp.items()},
                      TrainerConfig(opt=ocfg_t), device="cpu")
    data = ttrain.token_batches(ct.vocab_size, B, S)
    for _ in range(5):
        batch = next(data)
        jp, state, jm = step(jp, state, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        tm = trainer.train_step(data, batch)
        for k in ("loss", "grad_norm"):
            assert abs(tm[k] - float(jm[k])) <= 1e-5 * abs(float(jm[k])), \
                (k, tm[k], float(jm[k]))
        assert set(tm) == {"ce", "moe_aux", "grad_norm", "lr", "loss"}
    assert int(trainer.opt_state["step"]) == int(state["step"]) == 5


def test_token_batches_are_the_reference_s():
    for vocab, b, s, seed in ((512, 2, 40, 0), (128256, 2, 64, 3)):
        jd = jtrain.token_batches(vocab, b, s, seed)
        td = ttrain.token_batches(vocab, b, s, seed)
        for _ in range(3):
            jb, tb = next(jd), next(td)
            assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
            for k in jb:
                assert tb[k].dtype == np.int32
                assert_same(jb[k], tb[k], k)


# -- specs and counts ---------------------------------------------------------


def test_specs_flops_and_abstract_state_match_reference():
    """For every registered config (full and reduced) and every shape:
    ``input_specs`` (meta tensors: shapes and dtypes),
    ``cache_pspec_axes`` and ``model_flops`` equal the reference's, and
    ``abstract_state`` of the abstract params gives the reference's
    float32 moments and int32 step."""
    assert list_archs() == tuple(sorted(jax_archs()))
    assert sorted(SHAPES) == sorted(JSHAPES)
    for arch in list_archs():
        for reduced in (True, False):
            cj = jax_config(arch, reduced=reduced)
            ct = get_config(arch, reduced=reduced)
            for name, shape in SHAPES.items():
                js = japi.input_specs(cj, JSHAPES[name])
                ts = api.input_specs(ct, shape)
                flat_j = dict(js, **js.pop("cache", {}))
                flat_t = dict(ts, **ts.pop("cache", {}))
                assert sorted(flat_j) == sorted(flat_t), (arch, name)
                for k, v in flat_t.items():
                    assert v.is_meta, (arch, name, k)
                    assert tuple(v.shape) == flat_j[k].shape, (arch, name, k)
                    assert str(v.dtype) == f"torch.{flat_j[k].dtype}", \
                        (arch, name, k)
                assert api.model_flops(ct, shape) == \
                    japi.model_flops(cj, JSHAPES[name]), (arch, name)
                assert api.cache_pspec_axes(ct, 3, 64) == \
                    japi.cache_pspec_axes(cj, 3, 64), arch
            jparams, _ = japi.init_params(cj, abstract=True)
            tparams, _ = api.init_params(ct, abstract=True)
            jst, tst = jopt.abstract_state(jparams), \
                topt.abstract_state(tparams)
            assert tst["step"].is_meta and tst["step"].dtype == torch.int32
            assert jst["step"].dtype == jnp.int32
            for mom in ("m", "v"):
                assert sorted(jst[mom]) == sorted(tst[mom])
                for k, v in tst[mom].items():
                    assert v.is_meta and v.dtype == torch.float32
                    assert tuple(v.shape) == jst[mom][k].shape
                    assert jst[mom][k].dtype == jnp.float32


# -- the launcher -------------------------------------------------------------


def _bits(tree):
    """A checkpoint's tree with its bfloat16 tensors as their int16 bits
    (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.view(torch.int16)
    return tree



@pytest.mark.parametrize("arch", list_archs())
def test_launcher_trains_every_arch_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch X --device cpu`` runs
    for every registered config (reduced) and logs the reference's
    lines."""
    metrics = ttrain.main(["--arch", arch, "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and out.rstrip().endswith("done")
    assert np.isfinite(metrics["loss"])


def test_launcher_resume_is_bit_for_bit(tmp_path, capsys):
    """6 steps with ``--ckpt-every 3`` equal 3 steps, a restart and 3
    more (the step-6 checkpoint removed, so the run resumes from step
    3): params, moments and counter bit for bit.  A rerun at the last
    step resumes and trains nothing."""
    def run(d, steps=6):
        return ttrain.main(["--arch", "llama3.2-1b", "--device", "cpu",
                            "--steps", str(steps), "--ckpt-every", "3",
                            "--ckpt-dir", str(d), "--batch", "2",
                            "--seq", "24"])

    whole, parts = tmp_path / "whole", tmp_path / "parts"
    m_whole = run(whole)
    run(parts)
    assert ckpt_lib.list_steps(str(parts)) == [3, 6]
    shutil.rmtree(parts / "step_00000006")
    capsys.readouterr()
    m_parts = run(parts)
    assert "resumed from step 3" in capsys.readouterr().out
    assert m_parts == m_whole
    a, _ = ckpt_lib.restore(str(whole), 6)
    b, meta = ckpt_lib.restore(str(parts), 6)
    assert meta["step"] == 6
    assert a["params"]["embed/table"].dtype == torch.bfloat16
    assert_same(_bits(a), _bits(b), "state")
    assert run(parts) == {}
    assert "resumed from step 6" in capsys.readouterr().out


def test_launcher_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "llama3.2-1b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(get_config("llama3.2-1b", reduced=True))
