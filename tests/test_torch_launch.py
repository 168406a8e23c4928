"""The port's launch tooling on the CPU: the single-card dry run
(``launch/dryrun.py``), its matrix driver (``launch/run_all_dryruns.py``),
the H100 roofline (``launch/roofline.py``), ``launch/mesh.py``,
``distributed/elastic.py`` and the Model Engine's ``card_latency_us``.

Each pure function is held to the reference's on the same inputs, the
roofline and the latency with the port's card constants monkeypatched to
the reference's TPU ones (and the roofline at the reference's 256
chips): equal, bit for bit.  Then the trace itself, on meta tensors at
``reduced()`` widths (no JAX compile):

- the two-point layer extrapolation of a trace equals the trace at full
  depth exactly (FLOPs, bytes, transcendentals), one config per family
  and step kind;
- a meta trace along the CPU's path equals the same step run on CPU
  tensors (every count, the op histogram and the peak included);
- the live-bytes tracker gives a hand-counted peak;
- a traced decode step goes through kernel 4's custom op and counts its
  FLOP formula.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.configs.fenix_models import MODEL_CONFIGS as JMODELS
from repro.core.model_engine.inference import tpu_latency_us
from repro.distributed import elastic as jelastic
from repro.launch import roofline as jroof
from repro.launch import run_all_dryruns as jdrivers
from repro_torch._device import meta_as
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.fenix_models import MODEL_CONFIGS
from repro_torch.core.model_engine import inference
from repro_torch.distributed import elastic
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.decode_attention.kernel import decode_attention \
    as attn_kernel
from repro_torch.launch import dryrun, mesh, roofline, run_all_dryruns

# one config per family, at reduced() widths
FAMILY_ARCHS = {"transformer": "llama3.2-1b", "ssm": "mamba2-370m",
                "hybrid": "recurrentgemma-9b",
                "encdec": "seamless-m4t-medium",
                "vlm": "llama-3.2-vision-11b"}
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}
B, S = 2, 32     # the traced shapes' batch and sequence


def _ref_dryrun():
    """The reference's ``launch/dryrun`` module.  Importing it sets
    ``XLA_FLAGS`` for 512 host devices; the flags are put back so that
    no later JAX backend of this worker starts with them."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun


def _shape(kind):
    return dataclasses.replace(SHAPES[KIND_SHAPES[kind]], global_batch=B,
                               seq_len=S)


def _traced(cfg, kind, device_type="cuda"):
    step, args, _ = dryrun.build_step(cfg, _shape(kind))
    return dryrun.trace(step, args, device_type)[1]


# ---------------------------------------------------------------------------
# Pure functions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_cost_points_match_reference(arch):
    assert run_all_dryruns.cost_points(arch) == jdrivers.cost_points(arch)


def _point(rng, collectives):
    ob = {op: float(rng.integers(0, 1 << 30))
          for op in ("convert", "copy", "mm", "exp")
          if rng.random() < 0.8}
    per = {op: {"count": int(rng.integers(1, 9)),
                "bytes": float(rng.integers(0, 1 << 28))}
           for op in ("all-gather", "all-reduce") if collectives}
    return {"cost": {"flops": float(rng.integers(1, 1 << 50)),
                     "bytes_accessed": float(rng.integers(1, 1 << 45)),
                     "transcendentals": float(rng.integers(0, 1 << 30))},
            "op_bytes": ob,
            "collectives": {"per_op": per,
                            "total_bytes": sum(p["bytes"]
                                               for p in per.values())}}


@pytest.mark.parametrize("seed", range(4))
def test_extrapolate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    p1, p2 = _point(rng, seed % 2), _point(rng, seed % 2)
    xs = sorted(float(x) for x in rng.choice(8, 2, replace=False) + 1)
    x_full = float(rng.integers(1, 90))
    assert run_all_dryruns.extrapolate(p1, p2, xs[0], xs[1], x_full) \
        == jdrivers.extrapolate(p1, p2, xs[0], xs[1], x_full)


@pytest.fixture
def tpu_constants(monkeypatch):
    """The port's roofline at the reference's TPU v5e constants."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "CARD_GB", 16.0)


def _run(rng, arch, shape, x, reduced_over):
    """A dry run's result dict, as both packages write it (the port's
    collectives are none)."""
    return {"arch": arch, "shape": shape, "status": "ok",
            "overrides": reduced_over,
            "memory": {"argument_bytes": int(rng.integers(1, 1 << 36)),
                       "temp_bytes": int(rng.integers(1, 1 << 36)),
                       "arg_bytes_per_device_analytic":
                           float(rng.integers(1, 1 << 34)) * x},
            "cost": {"flops": float(rng.integers(1, 1 << 50)) * x,
                     "bytes_accessed": float(rng.integers(1, 1 << 45)),
                     "transcendentals": 0.0},
            "op_bytes": {"mm": float(rng.integers(1, 1 << 30))},
            "collectives": dict(dryrun.NO_COLLECTIVES)}


def _cells(seed):
    rng = np.random.default_rng(seed)
    out = []
    for arch in list_archs():
        for shape in SHAPES:
            over = {} if rng.random() < 0.5 else {
                "remat_policy": str(rng.choice(["nothing", "dots", "none"]))}
            points, xs, x_full = run_all_dryruns.cost_points(arch)
            # the same draws at both depths: costs grow with the layers
            seed_ = int(rng.integers(1 << 31))
            p1, p2 = (_run(np.random.default_rng(seed_), arch, shape, x,
                           over) for x in xs)
            cost = run_all_dryruns.extrapolate(p1, p2, xs[0], xs[1], x_full)
            cost.update({"arch": arch, "shape": shape, "status": "ok",
                         "point_results": [p1, p2]})
            proof = dict(_run(rng, arch, shape, 1.0, {}), compile_s=1.5,
                         trace_s=1.5)
            out.append((arch, shape, cost, proof))
    return out


def test_roofline_matches_reference(tpu_constants):
    """``analytic_memory_bytes``, ``analyse``, ``suggestion`` and
    ``table`` at the reference's constants and 256 chips: equal, with
    ``fits_card`` / ``trace_s`` / "fits card" in place of ``fits_16gb``
    / ``compile_s`` / "fits16GB"."""
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert roofline._layers_of(cfg) == jroof._layers_of(jcfg)
        for name in SHAPES:
            for over in ({}, {"remat_policy": "dots"},
                         {"remat_policy": "none"}):
                assert roofline.analytic_memory_bytes(
                    cfg, SHAPES[name], 3.5e9, over, 256) \
                    == jroof.analytic_memory_bytes(
                        jcfg, JSHAPES[name], 3.5e9, over, 256)
    port_cells, ref_cells = [], []
    for arch, shape, cost, proof in _cells(0):
        got = roofline.analyse(arch, shape, cost, proof, chips=256)
        want = jroof.analyse(arch, shape, cost, proof, chips=256)
        want["fits_card"] = want.pop("fits_16gb")
        want["trace_s"] = want.pop("compile_s")
        assert got == want, (arch, shape)
        port_cells.append({"arch": arch, "shape": shape, "status": "ok",
                           **got})
        ref_cells.append({"arch": arch, "shape": shape, "status": "ok",
                          **jroof.analyse(arch, shape, cost, proof,
                                          chips=256)})
        assert roofline.suggestion(got) == jroof.suggestion(want)
    skipped = {"arch": "llama3.2-1b", "shape": "long_500k",
               "status": "skipped"}
    failed = {"arch": "gemma-7b", "shape": "x", "status": "error"}
    port_cells += [skipped, failed]
    ref_cells += [skipped, failed]
    assert roofline.table(port_cells) \
        == jroof.table(ref_cells).replace("fits16GB", "fits card")


def test_scale_step_capacity_matches_reference():
    for old in (1, 8, 256):
        for new in (1, 3, 7, 16, 100, 512, 1000):
            for gb in (1, 2, 33, 256, 1000, 4096):
                assert elastic.scale_step_capacity(old, new, gb) \
                    == jelastic.scale_step_capacity(old, new, gb)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_card_latency_matches_tpu_latency(monkeypatch, name):
    """The TPU formula at the card's rates: equal to the reference's at
    the TPU's (197 TFLOP/s, 819 GB/s), for every FENIX model config."""
    monkeypatch.setattr(inference, "CARD_INT8_OPS_PER_S", 197e12)
    monkeypatch.setattr(inference, "CARD_HBM_BYTES_PER_S", 819e9)
    for batch in (1, 128, 4096):
        assert inference.card_latency_us(MODEL_CONFIGS[name](), batch) \
            == tpu_latency_us(JMODELS[name](), batch)


def test_apply_overrides_matches_reference():
    jdryrun = _ref_dryrun()
    over = {"num_layers": "3", "moe.top_k": "2", "tie_embeddings": "false",
            "attn_chunk_q": "256", "rope_theta": "5e5",
            "attention_impl": "chunked", "scan_layers": "False"}
    for arch in ("gemma-7b", "qwen2-moe-a2.7b"):
        got = dryrun.apply_overrides(get_config(arch), over)
        want = jdryrun.apply_overrides(jax_config(arch), over)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        dryrun.apply_overrides(get_config("gemma-7b"), {"moe.a.b": "1"})


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


def _depth(cfg, over):
    return dryrun.apply_overrides(cfg, over)


# the step kinds spread over the families (a train trace of the hybrid or
# the vlm at three blocks takes ~8 s on a CPU host)
@pytest.mark.parametrize("family,kind", [
    ("transformer", "train"), ("ssm", "prefill"), ("hybrid", "prefill"),
    ("encdec", "decode"), ("vlm", "prefill")])
def test_extrapolated_trace_equals_full_depth(family, kind):
    """``cost_points`` at depths 2 and 4 (hybrid / vlm: 1 and 2 blocks),
    extrapolated by ``extrapolate`` to 6 (3 blocks), against the trace at
    that depth: FLOPs, bytes and transcendentals exactly."""
    cfg = get_config(FAMILY_ARCHS[family], reduced=True)
    if family == "encdec":
        full = {"num_encoder_layers": "6", "num_decoder_layers": "6"}
    elif family == "hybrid":
        pat = len(cfg.hybrid.pattern)
        full = {"num_layers": str(3 * pat + cfg.num_layers % pat)}
    elif family == "vlm":
        full = {"num_layers": str(3 * cfg.cross_attn_every)}
    else:
        full = {"num_layers": "6"}
    cfg = _depth(cfg, {"scan_layers": "false", **full})
    points, xs, x_full = run_all_dryruns.cost_points_of(cfg)
    assert x_full == (3.0 if family in ("hybrid", "vlm") else 6.0)
    runs = [{"cost": _traced(_depth(cfg, ov), kind)} for ov in points]
    got = run_all_dryruns.extrapolate(runs[0], runs[1], xs[0], xs[1],
                                      x_full)
    want = _traced(cfg, kind)
    for k in ("flops", "bytes_accessed", "transcendentals"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert want["flops"] > 0 and want["bytes_accessed"] > 0


def _real(tree, gen):
    """Concrete CPU tensors of a meta tree's shapes: small normals, zero
    integers (token 0, position 0)."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype.is_floating_point:
            return (torch.randn(tree.shape, generator=gen) * 0.02) \
                .to(tree.dtype)
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _real(v, gen) for k, v in tree.items()}
    return type(tree)(_real(v, gen) for v in tree)


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "train"), ("llama3.2-1b", "decode"),
    ("qwen2-moe-a2.7b", "prefill")])
def test_meta_trace_on_cpu_path_equals_cpu_run(arch, kind):
    """A trace on meta tensors along the CPU's path (``meta_as("cpu")``:
    plain decode attention, the cast head) equals the same step run on
    CPU tensors: FLOPs, bytes, transcendentals, the op histogram and the
    memory, peak included."""
    cfg = get_config(arch, reduced=True)
    step, args, meta = dryrun.build_step(cfg, _shape(kind))
    _, on_meta = dryrun.trace(step, args, "cpu")
    _, on_cpu = dryrun.trace(step, _real(args, torch.Generator()
                                         .manual_seed(0)), "cpu")
    assert on_meta == on_cpu
    assert on_meta["argument_bytes"] == meta["arg_bytes_global"]


def test_live_bytes_hand_counted():
    """Views are not counted again; a storage leaves the count when its
    last view dies; in-place writes to an argument allocate nothing;
    every block is rounded up to 512 bytes."""
    def step(a):
        x = torch.empty(1000, device=a.device)           # 4000 -> 4096
        y = x.view(10, 100)[2:]                          # a view: 0
        del x
        z = y * 2                                        # 3200 -> 3584
        w = torch.ones(3000, device=a.device)            # 12000
        a.add_(1.0)                                      # the argument
        del y, z                                         # frees 4096+3584
        v = w[:10] + 1                                   # 40 -> 512
        return w, v

    a = torch.empty(7, device="meta")
    for arg in (a, torch.zeros(7)):
        _, c = dryrun.trace(step, (arg,), "cpu")
        assert c["temp_bytes"] == 4096 + 3584 + 12288
        assert c["argument_bytes"] == 28
        assert c["output_bytes"] == 12000 + 40
        # bytes: mul reads 3200 writes 3200; ones writes 12000; add_
        # reads and writes 28; the slice add reads 40 writes 40
        assert c["bytes_accessed"] == 6400 + 12000 + 56 + 80
        assert c["op_bytes"] == {"ones": 12000, "mul": 3200, "add": 40,
                                 "add_": 28}


def test_live_bytes_follow_autograd_saved_tensors():
    """A tensor autograd saves for the backward stays counted until the
    backward releases it, on meta and on CPU tensors alike."""
    def step(x):
        x = x.detach().requires_grad_()
        h = torch.exp(x)           # 4096, saved by exp's backward
        y = (h * 3).sum()          # 4096 (freed after the sum), 512
        del h
        g, = torch.autograd.grad(y, [x])
        return g

    for arg in (torch.empty(1024, device="meta"), torch.zeros(1024)):
        _, c = dryrun.trace(step, (arg,), "cpu")
        # at the peak: exp's saved result, the loss and its seed of ones,
        # the product's gradient and x's gradient
        assert c["temp_bytes"] == 3 * 4096 + 2 * 512
        assert c["output_bytes"] == 4096 and c["transcendentals"] == 1024


def test_traced_decode_goes_through_kernel_4():
    """On the card's path (meta's default) the decode step runs kernel
    4's custom op: its fake output, no launch, and the FLOP formula
    2 * B * Hq * S * (Dk + Dv) in place of the plain path's products;
    the plain path's float32 scores are not in the trace.  The head
    takes ``_MatmulF32`` (one ``mm`` with a float32 result, no float32
    copy of the table)."""
    cfg = get_config("llama3.2-1b", reduced=True)
    card = _traced(cfg, "decode")
    plain = _traced(cfg, "decode", "cpu")
    assert card["op_bytes"]["decode_attention"] > 0
    assert "decode_attention" not in plain["op_bytes"]
    assert "_softmax" not in card["op_bytes"]
    hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = torch.empty(B, hkv * g, cfg.head_dim, device="meta",
                    dtype=torch.bfloat16)
    k = torch.empty(B, S, hkv, cfg.head_dim, device="meta",
                    dtype=torch.bfloat16)
    lens = torch.empty(B, device="meta", dtype=torch.int32)
    before = attn_kernel.launches
    with FlopCounterMode(display=False) as fc:
        out = attn_ops.decode_attention(q, k, k, lens)
    assert out.is_meta and out.shape == q.shape \
        and out.dtype == torch.bfloat16
    per_layer = 2 * B * hkv * g * S * 2 * cfg.head_dim
    assert fc.get_total_flops() == per_layer
    assert attn_kernel.launches == before
    # the plain path's QK and PV products count the same FLOPs: the
    # totals agree, the bytes do not (no float32 score tensor)
    assert card["flops"] == plain["flops"]
    assert card["bytes_accessed"] < plain["bytes_accessed"]
    with meta_as("cpu"):
        with FlopCounterMode(display=False) as fc:
            out = attn_ops.decode_attention(q, k, k, lens)
    assert out.is_meta and fc.get_total_flops() == per_layer
    assert attn_kernel.launches == before
    cpu = [torch.zeros(B, hkv * g, cfg.head_dim),
           torch.zeros(B, S, hkv, cfg.head_dim),
           torch.zeros(B, S, hkv, cfg.head_dim),
           torch.ones(B, dtype=torch.int32)]
    with pytest.raises(ValueError, match="CUDA"):
        attn_ops.decode_attention(*cpu, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        attn_kernel(*cpu)


# ---------------------------------------------------------------------------
# run_cell, the CLI, the matrix driver and the roofline's reader
# ---------------------------------------------------------------------------

# the reference's run_cell keys; the port has trace_s in place of lower_s
# and compile_s, and neither sharding fallbacks nor HLO lines (no mesh,
# no HLO)
REF_KEYS = {"arch", "shape", "mesh", "mesh_shape", "chips", "overrides",
            "rules", "n_params", "lower_s", "compile_s",
            "sharding_fallbacks", "memory", "cost", "collectives",
            "op_bytes", "hlo_lines", "status", "total_s"}


def test_run_cell_keys_and_skip_reasons():
    res = dryrun.run_cell("qwen3-4b", "prefill_32k", reduced=True,
                          batch=B, seq_len=S)
    assert REF_KEYS - {"lower_s", "compile_s", "sharding_fallbacks",
                       "hlo_lines"} <= set(res)
    assert {"trace_s", "fits_card", "card_bytes"} <= set(res)
    assert res["status"] == "ok" and res["chips"] == 1
    assert res["mesh"] == "card"
    assert set(res["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes",
        "arg_bytes_global_analytic", "arg_bytes_per_device_analytic"}
    assert set(res["cost"]) == {"flops", "bytes_accessed",
                                "transcendentals"}
    assert res["collectives"]["total_bytes"] == 0.0
    assert res["collectives"]["per_op"] == {}
    assert res["fits_card"] and res["card_bytes"] == dryrun.H100_BYTES
    assert res["n_params"] == sum(
        v.numel() for v in dryrun.build_step(
            get_config("qwen3-4b", reduced=True), _shape("prefill"))[1][0]
        .values())
    for arch in list_archs():
        for name in SHAPES:
            ok, reason = jax_shape_applicable(jax_config(arch),
                                              JSHAPES[name])
            if ok:
                continue
            got = dryrun.run_cell(arch, name, "card", {})
            assert got == {"arch": arch, "shape": name, "mesh": "card",
                           "status": "skipped", "reason": reason}
    with pytest.raises(ValueError, match="16x16"):
        dryrun.run_cell("llama3.2-1b", "decode_32k", "single", {})
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("llama3.2-1b", "decode_32k", "card", {},
                        {"expert_cap": "data"})


def test_dryrun_cli_decode_32k(capsys, tmp_path):
    """The acceptance command: llama3.2-1b at decode_32k's full shape
    (batch 128, 32768 keys) on the CPU, no card: nonzero counts, one
    chip, and its K/V cache alone does not fit."""
    out = tmp_path / "cell.json"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--out", str(out)])
    res = json.loads(capsys.readouterr().out)
    assert res == json.loads(out.read_text())
    assert res["chips"] == 1 and res["status"] == "ok"
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes_accessed"] > 0
    assert res["memory"]["temp_bytes"] > 0
    assert res["memory"]["argument_bytes"] > 137e9 and not res["fits_card"]
    assert res["op_bytes"]["decode_attention"] == 128 * 32 * 64 * 2 * 16
    for bad, why in ((["--mesh", "single"], "16x16"),
                     (["--rule", "experts=data"], "no mesh"),
                     (["--save-hlo", "x.txt"], "no HLO")):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "llama3.2-1b", "--shape",
                         "decode_32k"] + bad)
        assert why in capsys.readouterr().err


def test_run_all_dryruns_then_roofline(tmp_path, capsys):
    """The matrix driver on one reduced cell (a proof run and two cost
    runs, each in its own subprocess: ~6 s each on a CPU host, most
    of it importing torch) and an inapplicable one; the roofline reads them
    back."""
    run_all_dryruns.main(["--only", "mamba2-370m,llama3.2-1b", "--shapes",
                          "long_500k", "--reduced", "--tag", "t",
                          "--out-dir", str(tmp_path)])
    log = capsys.readouterr().out
    tagdir = tmp_path / "t"
    assert (tagdir / "skip_llama3.2-1b_long_500k.json").exists()
    cost = json.loads((tagdir / "cost_mamba2-370m_long_500k.json")
                      .read_text())
    assert cost["status"] == "ok", log
    proof = json.loads((tagdir / "proof_mamba2-370m_long_500k_card.json")
                       .read_text())
    assert proof["status"] == "ok" and proof["reduced"]
    # the reduced mamba2 has 2 layers, cost_points' first depth
    assert cost["flops"] == proof["cost"]["flops"]
    cells = roofline.load_cells("t", str(tmp_path))
    assert {(c["arch"], c["shape"], c["status"]) for c in cells} == {
        ("mamba2-370m", "long_500k", "ok"),
        ("llama3.2-1b", "long_500k", "skipped")}
    for c in cells:
        if c["status"] == "ok":
            assert c["fits_card"] and c["collective_s"] == 0.0
            assert c["step_time_s"] == max(c["compute_s"], c["memory_s"])
    roofline.main(["--tag", "t", "--out-dir", str(tmp_path)])
    assert "| mamba2-370m | long_500k |" in capsys.readouterr().out


def test_analyse_run_of_a_cut_cell():
    """``analyse_run`` reads the shape a run traced (a cut batch) and
    its own arguments."""
    res = dryrun.run_cell("llama3.2-1b", "decode_32k", reduced=True,
                          batch=B, seq_len=S)
    got = roofline.analyse_run(res)
    cfg = get_config("llama3.2-1b", reduced=True)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=B,
                                seq_len=S)
    assert got["bytes_per_device"] == roofline.analytic_memory_bytes(
        cfg, shape, res["memory"]["arg_bytes_per_device_analytic"], {}, 1)
    assert got["compute_s"] == res["cost"]["flops"] / 989e12
    assert got["memory_s"] == got["bytes_per_device"] / 3.35e12


def test_mesh_and_elastic_on_one_card():
    assert mesh.smoke_mesh() is None and mesh.data_axes(None) == ()
    for call in (lambda: mesh.make_production_mesh(),
                 lambda: mesh.make_production_mesh(multi_pod=True),
                 lambda: mesh.make_mesh((4, 1), ("data", "model")),
                 lambda: mesh.data_axes(object())):
        with pytest.raises(ValueError, match="16x16"):
            call()
    cfg = get_config("llama3.2-1b", reduced=True)
    plan = elastic.plan_remesh(cfg)
    assert plan.n_devices == 1 and plan.fallbacks == []
    assert set(plan.pspecs) == set(dryrun.build_step(
        cfg, _shape("decode"))[1][0])
    assert set(plan.pspecs.values()) == {()}
    assert elastic.plan_remesh(cfg, (1, 1)).n_devices == 1
    with pytest.raises(ValueError, match="16x16"):
        elastic.plan_remesh(cfg, (2, 4))
    with pytest.raises(ValueError, match="16x16"):
        elastic.reshard_state({}, dataclasses.replace(plan,
                                                      mesh_shape=(2,)))
    import jax.numpy as jnp
    state = {"a/w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16)
                               .reshape(2, 3)),
             "b": np.arange(4, dtype=np.float32)}
    got = elastic.reshard_state(state, plan, "cpu")
    assert got["a/w"].dtype == torch.bfloat16
    assert got["a/w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    assert got["b"].tolist() == [0, 1, 2, 3]
