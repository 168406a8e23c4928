"""The port's hand-written Hopper kernels against their plain PyTorch
versions, and the replay and LM serving through them, on the card.  Needs an NVIDIA
GPU (marker ``gpu``); skips with a reason elsewhere.  Imports neither JAX nor ``repro``, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_on_card.py -q
"""

import itertools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import assert_same, cuda_device  # noqa: E402,F401
from repro_torch.configs.fenix_models import fenix_cnn_tiny  # noqa: E402
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import (  # noqa: E402
    EngineModel)
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)
from repro_torch.data.synthetic_traffic import (  # noqa: E402
    make_flows, packet_stream)
from repro_torch.kernels.int8_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.kernel import int8_gemm  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.rate_gate import ref as gate_ref  # noqa: E402
from repro_torch.kernels.rate_gate.kernel import (  # noqa: E402
    fused_gate, fused_gate_prng, rate_gate as rate_gate_kernel,
    rate_gate_prng, threefry_draw)
from repro_torch.kernels.rate_gate.ops import (  # noqa: E402
    fused_admission, rate_gate)
from repro_torch.kernels.decode_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention as decode_attention_kernel)

pytestmark = pytest.mark.gpu


def _gate_case(rng, n, dev):
    lut = rng.integers(0, 1 << 16, (64, 32)).astype(np.int32)
    lut[rng.random((64, 32)) < 0.2] = 0
    ts = np.sort(rng.integers(10_000, 10_000 + 3 * n, n))
    arrs = dict(t_i=rng.integers(-50, 70_000, n),
                c_i=rng.integers(-3, 40, n), ts=ts,
                rand16=rng.integers(0, 1 << 16, n), lut=lut,
                bucket=rng.integers(0, 300),
                t_last=0 if rng.random() < 0.3 else ts[0] - 7)
    return {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
            for k, v in arrs.items()}


# one CTA, one cluster (up to 8192 lanes) and past it: the look-back over
# 3, 7, 256 and 1024 tiles of 4096 lanes (1024 tiles are about four waves
# of the 264 1024-thread CTAs an H100 holds at once)
GATE_SIZES = [1, 255, 1000, 4096, 8192, 8193, 3 * 8192 + 5, 1 << 20,
              1 << 22]
BIND_SIZES = [4096, 8192, 8193, 3 * 8192 + 5, 1 << 20, 1 << 22]
BIND_COST, BIND_CAP = 3, 1 << 30


def _binding_case(rng, n, dev):
    """A batch on which the token bucket binds all along: a small
    starting bucket and timestamps that advance at the selected lanes'
    expected spend, ahead of it and then behind it twice in the batch, so
    that about half of the selected lanes are denied in runs that cross
    CTAs and tiles; the cap never clips the bucket level."""
    lut = rng.integers(0, 1 << 16, (64, 32))
    lut[rng.random((64, 32)) < 0.2] = 0
    t_i, c_i = rng.integers(0, 70_000, n), rng.integers(0, 40, n)
    prob = lut[np.minimum(t_i >> 10, 63), np.minimum(c_i, 31)]
    rate = BIND_COST * prob.mean() / (1 << 16)
    period = n / 2
    swing = 0.9 * rate * period / (2 * np.pi)   # keeps ts non-decreasing
    i = np.arange(n)
    ts = 10_000 + np.floor(rate * i + swing * np.sin(2 * np.pi * i / period))
    arrs = dict(t_i=t_i, c_i=c_i, ts=ts, rand16=rng.integers(0, 1 << 16, n),
                lut=lut, bucket=rng.integers(0, 4 * BIND_COST),
                t_last=0 if rng.random() < 0.5 else
                ts[0] - rng.integers(0, 9))
    return {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
            for k, v in arrs.items()}


@pytest.mark.parametrize("n", GATE_SIZES)
def test_fused_gate_kernel_matches_plain(n, cuda_device):
    rng = np.random.default_rng(n)
    before = fused_gate.launches
    for _ in range(4):
        c = _gate_case(rng, n, cuda_device)
        res = {}
        for backend in ("ref", "cuda"):
            res[backend] = fused_admission(
                c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"], rand16=c["rand16"], cost_us=3,
                bucket_cap_us=150, backend=backend)
        torch.cuda.synchronize()
        assert_same(res["ref"], res["cuda"], f"n={n}")
    assert fused_gate.launches == before + 4


def _key(rng, dev):
    return torch.from_numpy(rng.integers(0, 2**32, 2, dtype=np.int64)
                            ).to(dev)


@pytest.mark.parametrize("n", GATE_SIZES)
def test_fused_gate_prng_kernel_matches_plain(n, cuda_device):
    """The drawing kernel against fused_admission_ref on the draws of
    the same key."""
    rng = np.random.default_rng(100 + n)
    before = fused_gate_prng.launches
    for _ in range(4):
        c = _gate_case(rng, n, cuda_device)
        key = _key(rng, cuda_device)
        res = {}
        for backend in ("ref", "cuda", "cuda_prng"):
            res[backend] = fused_admission(
                c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"], key=key, cost_us=3, bucket_cap_us=150,
                backend=backend)
        torch.cuda.synchronize()
        assert_same(res["ref"], res["cuda_prng"], f"n={n}")
        assert_same(res["ref"], res["cuda"], f"n={n}")
    assert fused_gate_prng.launches == before + 4


def _misaligned(x):
    """A copy of ``x`` at a storage offset of one element: contiguous,
    4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x
    return buf[1:]


@pytest.mark.parametrize("n", [1000, 8192, 3 * 8192 + 5])
def test_fused_gate_kernels_take_misaligned_lanes(n, cuda_device):
    """Lanes that are not 16-byte aligned (the kernels' 4-byte load path)
    give the plain versions' results, through the kernel wrappers
    (bucket, t_last in place of the old register pair) and through
    fused_admission; each call launches its kernel once."""
    rng = np.random.default_rng(900 + n)
    c = _gate_case(rng, n, cuda_device)
    key = _key(rng, cuda_device)
    lanes = [_misaligned(c[k]) for k in ("t_i", "c_i", "ts", "rand16")]
    assert all(x.data_ptr() % 16 == 4 for x in lanes)
    regs = (c["bucket"], c["t_last"])
    kw = dict(t_shift=10, c_shift=0, cost_us=3, bucket_cap_us=150)
    t_ref = torch.where(c["t_last"] == 0, c["ts"][0], c["t_last"])
    burst0 = torch.clamp_max(c["bucket"], 150)
    plain = gate_ref.fused_admission_ref(c["t_i"], c["c_i"], c["ts"],
                                         c["lut"], c["rand16"], burst0,
                                         t_ref, 10, 0, 3, 150)
    plain_d = gate_ref.fused_admission_prng_ref(c["t_i"], c["c_i"], c["ts"],
                                                c["lut"], key, burst0,
                                                t_ref, 10, 0, 3, 150, 16)
    before = (fused_gate.launches, fused_gate_prng.launches)
    got = fused_gate(*lanes, c["lut"], *regs, **kw)
    got_d = fused_gate_prng(*lanes[:3], key, c["lut"], *regs, prob_bits=16,
                            **kw)
    via_op = fused_admission(*lanes[:3], c["lut"], *regs, rand16=lanes[3],
                             cost_us=3, bucket_cap_us=150)
    via_op_d = fused_admission(*lanes[:3], c["lut"], *regs, key=key,
                               cost_us=3, bucket_cap_us=150,
                               backend="cuda_prng")
    torch.cuda.synchronize()
    for a, b in ((plain, got), (plain, via_op), (plain_d, got_d),
                 (plain_d, via_op_d)):
        assert_same(a, b, f"n={n}")
    assert (fused_gate.launches, fused_gate_prng.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("n", BIND_SIZES)
def test_fused_gate_kernels_when_the_bucket_binds(n, cuda_device):
    """Both kernels through fused_admission against their plain versions
    on batches where the bucket denies a real share of the selected lanes
    in every swing and ends strictly inside (0, cap): the spend carried
    between the CTAs of a cluster and across look-back tiles, and the
    grant count of every CTA, decide the outputs."""
    rng = np.random.default_rng(300 + n)
    kw = dict(cost_us=BIND_COST, bucket_cap_us=BIND_CAP)
    for _ in range(2):
        c = _binding_case(rng, n, cuda_device)
        key = _key(rng, cuda_device)
        args = (c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"])
        prob = gate_ref.lut_prob(c["lut"], c["t_i"], c["c_i"], 10, 0)
        for backend, draws, rand in (
                ("cuda", dict(rand16=c["rand16"]), c["rand16"]),
                ("cuda_prng", dict(key=key),
                 gate_ref.draw_rand16(key, n, 16))):
            plain = fused_admission(*args, backend="ref", **draws, **kw)
            got = fused_admission(*args, backend=backend, **draws, **kw)
            assert_same(plain, got, f"{backend} n={n}")
            sel, granted = int((rand < prob).sum()), int(plain[0].sum())
            assert 0.1 * sel < sel - granted < 0.9 * sel, (sel, granted)
            assert 0 < int(plain[1]) < BIND_CAP, int(plain[1])


@pytest.mark.parametrize("n", [1000, 4096, 3 * 8192 + 5])
@pytest.mark.parametrize("branch", ["t_last_zero", "bucket_over_cap"])
def test_fused_gate_kernels_batch_start_registers(branch, n, cuda_device):
    """The two branches of the batch-start registers that the kernels
    derive themselves, forced on every trial: t_last == 0 (the refill
    anchor is ts[0]) and bucket > bucket_cap_us (the burst is capped),
    through the "cuda" and "cuda_prng" backends."""
    rng = np.random.default_rng(400 + n + len(branch))
    for _ in range(4):
        c = _gate_case(rng, n, cuda_device)
        if branch == "t_last_zero":
            c["t_last"].zero_()
        else:
            c["bucket"].fill_(150 + 1 + int(rng.integers(0, 450)))
        key = _key(rng, cuda_device)
        args = (c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"])
        kw = dict(cost_us=3, bucket_cap_us=150)
        for backend, draws in (("cuda", dict(rand16=c["rand16"])),
                               ("cuda_prng", dict(key=key))):
            plain = fused_admission(*args, backend="ref", **draws, **kw)
            got = fused_admission(*args, backend=backend, **draws, **kw)
            assert_same(plain, got, f"{branch} {backend} n={n}")


# -- the pipe-batched gates: P pipes' batches in one launch ------------------

PIPE_SIZES = [1, 1000, 1024, 4096, 8192, 1 << 20]


def _pipes_case(rng, pipes, n, dev, bind=None):
    """P pipes' batches stacked ([P, n] lanes, [P, 64, 32] LUTs, [P]
    registers, [P, 2] keys), each pipe drawn on its own; with ``bind`` =
    q, pipe q's batch binds (``_binding_case``) and every other pipe's
    bucket is full, so only pipe q is denied."""
    cases = []
    for q in range(pipes):
        c = (_binding_case(rng, n, dev) if q == bind
             else _gate_case(rng, n, dev))
        if bind is not None and q != bind:
            c["bucket"].fill_(BIND_CAP)
        c["key"] = _key(rng, dev)
        cases.append(c)
    return {k: torch.stack([c[k] for c in cases]).contiguous()
            for k in cases[0]}


def _pipes_check(c, cost, cap):
    """Both kernels on the stacked case, one launch each, against the
    plain version over [P, n] and against one launch a pipe; returns the
    plain version's (granted, bucket') of each and its draws."""
    args = (c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
            c["t_last"])
    kw = dict(cost_us=cost, bucket_cap_us=cap)
    out = {}
    for kern, backend, draws in ((fused_gate, "cuda",
                                  dict(rand16=c["rand16"])),
                                 (fused_gate_prng, "cuda_prng",
                                  dict(key=c["key"]))):
        plain = fused_admission(*args, backend="ref", **draws, **kw)
        before = kern.launches
        got = fused_admission(*args, backend=backend, **draws, **kw)
        assert kern.launches == before + 1
        one = [fused_admission(*(x[q] for x in args), backend=backend,
                               **{k: v[q] for k, v in draws.items()}, **kw)
               for q in range(c["t_i"].shape[0])]
        torch.cuda.synchronize()
        assert_same(plain, got, backend)
        assert_same([torch.stack([o[0] for o in one]),
                     torch.stack([o[1] for o in one])], list(got), backend)
        out[backend] = plain
    return out


@pytest.mark.parametrize("n", PIPE_SIZES)
@pytest.mark.parametrize("pipes", [1, 2, 4, 8])
def test_pipe_batched_gate_kernels_match_plain(pipes, n, cuda_device):
    """One launch admits every pipe's batch (its own LUT, registers and
    key) exactly as the plain version over [P, n] and as one launch a
    pipe: one CTA, one cluster and the look-back, a pipe a grid row."""
    rng = np.random.default_rng(1000 * pipes + n)
    for _ in range(2):
        _pipes_check(_pipes_case(rng, pipes, n, cuda_device), 3, 150)


@pytest.mark.parametrize("n", [4096, 8192, 3 * 8192 + 5, 1 << 20])
@pytest.mark.parametrize("pipes", [2, 4, 8])
def test_pipe_batched_gate_kernels_when_one_pipe_binds(pipes, n,
                                                       cuda_device):
    """The bucket binds in one pipe only, across CTAs and look-back
    tiles: that pipe denies about half of its selected lanes and no other
    pipe denies any, so a kernel that read another pipe's LUT, registers,
    key or look-back scratch would differ."""
    rng = np.random.default_rng(7 * pipes + n)
    bind = int(rng.integers(0, pipes))
    c = _pipes_case(rng, pipes, n, cuda_device, bind=bind)
    res = _pipes_check(c, BIND_COST, BIND_CAP)
    prob = gate_ref.lut_prob(c["lut"], c["t_i"], c["c_i"], 10, 0)
    for backend, rand in (("cuda", c["rand16"]),
                          ("cuda_prng", gate_ref.draw_rand16(c["key"], n,
                                                             16))):
        selected = (rand < prob).sum(-1)
        denied = (selected - res[backend][0].sum(-1)).tolist()
        sel = int(selected[bind])
        assert 0.1 * sel < denied[bind] < 0.9 * sel, (backend, denied)
        assert sum(denied) == denied[bind], (backend, denied)


def test_pipe_batched_gate_wrappers_check_their_shapes(cuda_device):
    rng = np.random.default_rng(0)
    c = _pipes_case(rng, 2, 64, cuda_device)
    kw = dict(t_shift=10, c_shift=0, cost_us=3, bucket_cap_us=150)
    lanes = (c["t_i"], c["c_i"], c["ts"])
    with pytest.raises(ValueError, match="lut"):
        fused_gate(*lanes, c["rand16"], c["lut"][0], c["bucket"],
                   c["t_last"], **kw)
    with pytest.raises(ValueError, match="bucket"):
        fused_gate(*lanes, c["rand16"], c["lut"], c["bucket"][:1],
                   c["t_last"], **kw)
    with pytest.raises(ValueError, match="key"):
        fused_gate_prng(*lanes, c["key"][0], c["lut"], c["bucket"],
                        c["t_last"], prob_bits=16, **kw)


def _pipes_system(driver, dev, step, gate=None, **kw):
    cfg = dict(batch_size=256, control_plane_every=3, driver=driver,
               num_pipes=4, num_engines=4 if driver == "farm" else 1,
               step_backend=step, **kw)
    if gate is not None:
        cfg["gate_backend"] = gate
    return FenixSystem(FenixConfig(**cfg), _tiny_model(), device=dev)


@pytest.mark.parametrize("gate", ["cuda", "cuda_prng"])
@pytest.mark.parametrize("driver", ["pipes", "farm"])
def test_pipes_and_farm_graph_eager_plain_and_cpu(driver, gate,
                                                  cuda_device):
    """The pipes (P=4) and farm (P=4 x E=4) drivers on the card: graph ==
    eager == the plain backends == the CPU over two run_trace calls with
    ragged tails (verdicts, stats, stacked carry), one gate launch a
    uniform step and a tail, no host sync."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=4000)
    parts = [{k: v[lo:hi] for k, v in stream.items()}
             for lo, hi in ((0, 2600), (2600, 4000))]
    names = ("pstate", "pqueues", "pdl") + (("eq",) if driver == "farm"
                                           else ())
    runs = {}
    for name, dev, step, kw in (
            ("cpu", "cpu", "eager", {}),
            ("plain", cuda_device, "graph",
             dict(gate="ref", matmul_backend="ref")),
            ("eager", cuda_device, "eager", dict(gate=gate)),
            ("graph", cuda_device, "graph", dict(gate=gate))):
        sys_ = _pipes_system(driver, dev, step, **kw)
        before = _counts()
        verdicts = [sys_.run_trace(part)["verdict"] for part in parts]
        runs[name] = (verdicts, sys_, tuple(a - b for a, b in
                                            zip(_counts(), before)))
        assert sys_.host_syncs == 0
    rounds = sum(int((c // 256).max()) + int((c % 256 > 0).sum())
                 for c in (runs["cpu"][1]._route_pipes(p)[2]
                           for p in parts))
    gates = runs["graph"][2][0] + runs["graph"][2][1]
    assert runs["graph"][2] == runs["eager"][2] and gates == rounds
    assert runs["plain"][2] == (0, 0, 0, 0)
    for name in ("plain", "eager", "graph"):
        for a, b in zip(runs["cpu"][0], runs[name][0]):
            assert np.array_equal(a, b), name
        assert runs[name][1].stats == runs["cpu"][1].stats, name
        for carry in names:
            assert_same(getattr(runs["cpu"][1], carry),
                        getattr(runs[name][1], carry), f"{name} {carry}")
    assert runs["cpu"][1].stats["inferences"] > 0


# -- the chunk step's threefry draws: one launch for every pipe -------------

# carry keys: words 0 and 2^32 - 1, the cells' own (PRNGKey(0) of the
# device driver, PRNGKey(p) of a pipe) and a high word past 2^31
DRAW_KEYS = [[0, 0], [0, 1], [0, 2], [0, 3], [0, 2**32 - 1],
             [2**32 - 1, 0], [2**32 - 1, 2**32 - 1], [2**31, 2**31 - 1]]


@pytest.mark.parametrize("prob_bits", [1, 16, 31])
@pytest.mark.parametrize("n", [0, 1, 1000, 4096, 3 * 8192 + 5])
@pytest.mark.parametrize("pipes", [1, 4, 8])
def test_threefry_draw_matches_plain(pipes, n, prob_bits, cuda_device):
    """key', sub and the draws of one launch equal prng.split and
    prng.randint bit for bit, pipe by pipe, on the edge keys and random
    ones; the key is not written."""
    rng = np.random.default_rng(97 * pipes + n + prob_bits)
    keys = torch.tensor(DRAW_KEYS + rng.integers(0, 2**32, (8, 2)).tolist(),
                        dtype=torch.int64, device=cuda_device)
    before = threefry_draw.launches
    for lo in range(0, keys.shape[0], pipes):
        key = keys[lo:lo + pipes].contiguous()
        kept = key.clone()
        got = threefry_draw(key, n, prob_bits)
        want = gate_ref.threefry_draw_ref(key, n, prob_bits)
        torch.cuda.synchronize()
        assert_same(list(want), list(got), f"keys {kept.tolist()}")
        assert got[2].shape == (pipes, n) and got[2].dtype == torch.int32
        assert torch.equal(key, kept)
    assert threefry_draw.launches == before + keys.shape[0] // pipes


def test_threefry_draw_carries_the_pipes_key_chain(cuda_device):
    """64 steps of the pipes' carry chain from PRNGKey(p): each step's
    key' feeds the next, as in a replay, and stays the plain chain's."""
    key = torch.tensor([[0, p] for p in range(4)], dtype=torch.int64,
                       device=cuda_device)
    plain = key.clone()
    for step in range(64):
        key, _, rand = threefry_draw(key, 4096, 16)
        plain, _, want = gate_ref.threefry_draw_ref(plain, 4096, 16)
        assert torch.equal(rand, want), step
    assert torch.equal(key, plain)


def test_threefry_draw_refuses_what_it_cannot_take(cuda_device):
    key = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    for bad in (key.int(), key[0], torch.zeros((4, 3), dtype=torch.int64,
                                               device=cuda_device),
                torch.zeros((4, 4), dtype=torch.int64,
                            device=cuda_device)[:, :2],
                torch.zeros((0, 2), dtype=torch.int64, device=cuda_device)):
        with pytest.raises(ValueError, match="key"):
            threefry_draw(bad, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        threefry_draw(key.cpu(), 16, 16)
    for bits in (0, 32):
        with pytest.raises(ValueError, match="prob_bits"):
            threefry_draw(key, 16, bits)
    with pytest.raises(ValueError, match="n must"):
        threefry_draw(key, -1, 16)


def _draw_step_case(pipes, dev, n=48, seed=5):
    """A fresh stacked state of P pipes and a batch [P, n] on ``dev``,
    on LUT probabilities below 1, so the draws decide grants."""
    from repro_torch.core.data_engine import state as tstate

    cfg = tstate.EngineConfig(n_slots_log2=6, fpga_hz=2e5)
    state = tstate.init_pipes_state(cfg, pipes, n_est=500, q_est_pps=1e6,
                                    device=dev)
    pk = tstate.make_packets(np.random.default_rng(seed), pipes * n)
    pk = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                              else v).reshape(pipes, n).to(dev)
          for k, v in pk.items()}
    pk["ts_us"] = torch.sort(pk["ts_us"], dim=-1).values
    return tstate.local_engine_config(cfg, pipes), state, pk


@pytest.mark.parametrize("gate", ["cuda", "cuda_prng"])
@pytest.mark.parametrize("pipes", [1, 4])
def test_card_step_draws_without_the_plain_threefry(pipes, gate,
                                                    cuda_device,
                                                    monkeypatch):
    """process_pipes_fast under the kernel gates calls neither prng.split
    nor prng.randint, launches one threefry_draw a step, and gives the
    plain backend's state and outputs over three steps."""
    import dataclasses

    from repro_torch.core.data_engine import engine as de

    runs = {}
    for backend in ("ref", gate):
        if backend != "ref":
            def plain(*a, **kw):
                raise AssertionError("the plain threefry ran on a kernel "
                                     "gate's path")
            monkeypatch.setattr(prng, "split", plain)
            monkeypatch.setattr(prng, "randint", plain)
        cfg, state, pk = _draw_step_case(pipes, cuda_device)
        cfg = dataclasses.replace(cfg, gate_backend=backend)
        before, outs = threefry_draw.launches, []
        for step in range(3):
            state, out = de.process_pipes_fast(state, pk, cfg)
            outs.append(out)
            pk["ts_us"] = pk["ts_us"] + 200
        torch.cuda.synchronize()
        runs[backend] = (state, outs, threefry_draw.launches - before)
    assert runs["ref"][2] == 0 and runs[gate][2] == 3
    assert_same(runs["ref"][0], runs[gate][0], "state")
    assert_same(runs["ref"][1], runs[gate][1], "outputs")
    assert 0 < sum(int(o["granted"].sum()) for o in runs[gate][1]) \
        < 3 * 48 * pipes


@pytest.mark.parametrize("gate", ["cuda", "cuda_prng"])
@pytest.mark.parametrize("driver", ["device", "pipes", "farm"])
def test_chunk_steps_launch_one_threefry_draw_each(driver, gate,
                                                   cuda_device):
    """Every step of every driver (P = 1, 4 and 4 x 4), captured chunk
    steps and eager tails alike, launches one threefry_draw: as many as
    the gate kernel launches; the plain gate none, with the same
    verdicts."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    kw = dict(batch_size=256, control_plane_every=3, driver=driver)
    if driver != "device":
        kw.update(num_pipes=4, num_engines=4 if driver == "farm" else 1)
    runs = {}
    for backend in ("ref", gate):
        sys_ = FenixSystem(FenixConfig(gate_backend=backend, **kw),
                           _tiny_model(), device=cuda_device)
        assert sys_.step_backend == "graph"
        draws = threefry_draw.launches
        gates = fused_gate.launches + fused_gate_prng.launches
        verdict = sys_.run_trace(dict(stream))["verdict"]
        runs[backend] = (verdict, threefry_draw.launches - draws,
                         fused_gate.launches + fused_gate_prng.launches
                         - gates)
    assert runs["ref"][1:] == (0, 0)
    assert runs[gate][1] == runs[gate][2] > 0, runs[gate]
    assert np.array_equal(runs["ref"][0], runs[gate][0])


@pytest.mark.parametrize("n", [1, 255, 1000, 4096, 100_000])
def test_rate_gate_kernels_match_plain(n, cuda_device):
    """Both selection-only kernels against their plain versions."""
    rng = np.random.default_rng(200 + n)
    before = (rate_gate_kernel.launches, rate_gate_prng.launches)
    for trial in range(3):
        c = _gate_case(rng, n, cuda_device)
        plain = rate_gate(c["t_i"], c["c_i"], c["lut"], rand16=c["rand16"],
                          backend="ref")
        got = rate_gate(c["t_i"], c["c_i"], c["lut"], rand16=c["rand16"])
        seed = int(rng.integers(0, 2**31))
        plain_d = gate_ref.rate_gate_prng_ref(
            c["t_i"], c["c_i"], c["lut"], prng.PRNGKey(seed, cuda_device),
            10, 0, 16)
        got_d = rate_gate(c["t_i"], c["c_i"], c["lut"], seed=seed,
                          backend="cuda_prng")
        torch.cuda.synchronize()
        assert_same(plain, got, f"n={n}")
        assert_same(plain_d, got_d, f"n={n} seed={seed}")
    assert (rate_gate_kernel.launches, rate_gate_prng.launches) == (
        before[0] + 3, before[1] + 3)


# the serving path's six GEMMs (chip_smoke.PATH_GEMMS), then ragged M/N/K:
# the tiny model's K (24, 8, 16), odd K, M = 1
@pytest.mark.parametrize("shape", [
    (9216, 96, 64), (9216, 192, 128), (9216, 384, 256), (1024, 256, 512),
    (1024, 512, 256), (1024, 256, 7),
    (1, 1, 1), (5, 33, 7), (130, 70, 129), (77, 512, 300), (1, 256, 7),
    (2304, 24, 16), (300, 8, 7), (1024, 16, 7), (1, 96, 64)])
def test_int8_gemm_kernel_matches_plain(shape, cuda_device):
    """The kernel on a K-major B (as the serving weights are held), bias
    and no bias, every shift, at max |diff| = 0."""
    rng = np.random.default_rng(sum(shape))
    m, k, n = shape
    a, b = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)
                             ).to(cuda_device) for s in ((m, k), (k, n)))
    b = mm_ops.k_major(b)
    bias = torch.from_numpy(rng.integers(-40_000, 40_000, n,
                                         dtype=np.int32)).to(cuda_device)
    before = int8_gemm.launches
    shifts = (None, 0, 1, 7, 9)
    for shift in shifts:
        for bb in (None, bias):
            ref = mm_ops.int8_matmul(a, b, bb, shift, backend="ref")
            got = mm_ops.int8_matmul(a, b, bb, shift, backend="cuda")
            torch.cuda.synchronize()
            assert_same(ref, got, f"{shape} shift={shift}")
    assert int8_gemm.launches == before + 2 * len(shifts)


def test_int8_gemm_kernel_refuses_a_row_major_b(cuda_device):
    """The kernel reads B K-major and transposes nothing on the fly."""
    a = torch.zeros(64, 32, dtype=torch.int8, device=cuda_device)
    b = torch.zeros(32, 16, dtype=torch.int8, device=cuda_device)
    before = int8_gemm.launches
    with pytest.raises(ValueError, match="K-major"):
        int8_gemm(a, b)
    with pytest.raises(ValueError, match="K-major"):
        mm_ops.int8_matmul(a, b, backend="cuda")
    assert int8_gemm.launches == before
    assert torch.equal(int8_gemm(a, mm_ops.k_major(b)),
                       torch.zeros(64, 16, dtype=torch.int32,
                                   device=cuda_device))


def _tiny_model(seed=0):
    """Random int8 weights in quantize_traffic's layout (tiny CNN), held
    as the serving path holds them (qparams_from_numpy: K-major)."""
    cfg = fenix_cnn_tiny()
    rng = np.random.default_rng(seed)
    e, ch, fc = cfg.embed_dim, cfg.conv_filters[0], cfg.fc_dims[0]

    def w8(*shape):
        return rng.integers(-127, 128, shape, dtype=np.int8)

    def b32(n):
        return rng.integers(-500, 500, n, dtype=np.int32)

    qp = {"embed_len/table": w8(cfg.len_buckets, e),
          "embed_ipd/table": w8(cfg.ipd_buckets, e),
          "conv0/w": w8(cfg.conv_kernel, 2 * e, ch), "conv0/b": b32(ch),
          "conv0/shift": 9, "pool/mult": round((1 << 15) / cfg.seq_len),
          "fc0/w": w8(ch, fc), "fc0/b": b32(fc), "fc0/shift": 8,
          "head/w": w8(fc, cfg.num_classes), "head/b": b32(cfg.num_classes),
          "head/shift": 0, "cfg_shifts": {}}
    return EngineModel(cfg, qparams_from_numpy(qp))


def test_replay_with_kernels_matches_plain_and_cpu(cuda_device):
    """The slice on the card through both kernels gives the verdicts and
    stats of the plain backends on the card and of the CPU run."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    runs = {}
    for name, kw, dev in (("cpu", {}, "cpu"),
                          ("ref", dict(gate_backend="ref",
                                       matmul_backend="ref"), cuda_device),
                          ("cuda", {}, cuda_device)):
        gates, gemms = fused_gate.launches, int8_gemm.launches
        sys_ = FenixSystem(FenixConfig(batch_size=256,
                                       control_plane_every=3, **kw),
                           _tiny_model(), device=dev)
        runs[name] = (sys_.run_trace(dict(stream))["verdict"], sys_.stats)
        assert sys_.host_syncs == 0
        launched = (fused_gate.launches - gates, int8_gemm.launches - gemms)
        assert launched == ((8, 8 * 3) if name == "cuda" else (0, 0)), name
    for name in ("ref", "cuda"):
        assert np.array_equal(runs[name][0], runs["cpu"][0]), name
        assert runs[name][1] == runs["cpu"][1], name
    assert runs["cpu"][1]["inferences"] > 0


def test_cuda_prng_replay_matches_cuda_replay(cuda_device):
    """The slice with the drawing gate kernel gives the verdicts and
    stats of the rand-input kernel, one launch a chunk."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    runs = {}
    for backend in ("cuda", "cuda_prng"):
        before = (fused_gate.launches, fused_gate_prng.launches)
        sys_ = FenixSystem(FenixConfig(batch_size=256,
                                       control_plane_every=3,
                                       gate_backend=backend),
                           _tiny_model(), device=cuda_device)
        runs[backend] = (sys_.run_trace(dict(stream))["verdict"],
                         sys_.stats)
        launched = (fused_gate.launches - before[0],
                    fused_gate_prng.launches - before[1])
        assert launched == ((8, 0) if backend == "cuda" else (0, 8))
    assert np.array_equal(runs["cuda"][0], runs["cuda_prng"][0])
    assert runs["cuda"][1] == runs["cuda_prng"][1]


# -- the compiled steps: CUDA graphs against the eager step ------------------


def _counts():
    return (fused_gate.launches, fused_gate_prng.launches,
            int8_gemm.launches, decode_attention_kernel.launches)


def _graph_case(case, dev):
    """(config kwargs, model, tree, system kwargs) of a replay case."""
    from repro_torch.core.data_engine.decision_tree import (fit_tree,
                                                            tree_arrays)
    from repro_torch.core.data_engine.state import EngineConfig
    from repro_torch.core.model_engine.inference import ByLenModel
    from repro_torch.core.model_engine.vector_io import IOConfig
    from repro_torch.data.synthetic_traffic import windows_from_flows

    base = dict(batch_size=256, control_plane_every=3)
    if case == "binding":
        # a slow Model Engine: the bucket denies grants, the ring fills
        return (dict(engine=EngineConfig(fpga_hz=2e4),
                     io=IOConfig(queue_len=64), batch_size=200,
                     control_plane_every=2), ByLenModel(), None,
                dict(n_est=50, q_est_pps=2e4))
    tree = None
    if case == "tree":
        x, y, _ = windows_from_flows(make_flows("iscx", 40, seed=7))
        tree = tree_arrays(fit_tree(x[:, -1, :], y, depth=4,
                                    num_classes=7), dev)
    if case == "cuda_prng":
        base["gate_backend"] = "cuda_prng"
    return base, _tiny_model(), tree, {}


@pytest.mark.parametrize("case", ["cuda", "cuda_prng", "tree", "binding"])
def test_graph_replay_matches_eager_replay(case, cuda_device):
    """The chunk step replayed as CUDA graphs against the same step run
    eagerly, over two run_trace calls on one system (each with a ragged
    tail; the second reuses the graphs): verdicts, stats, the final
    state, queue and delay-line tensors bit for bit, the same kernel
    counts, no host sync (the loop runs under sync-debug "error")."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    parts = [{k: v[lo:hi] for k, v in stream.items()}
             for lo, hi in ((0, 1100), (1100, 1800))]
    cfg_kw, model, tree, sys_kw = _graph_case(case, cuda_device)
    runs = {}
    for backend in ("eager", "graph"):
        before = _counts()
        sys_ = FenixSystem(FenixConfig(step_backend=backend, **cfg_kw),
                           model, tree=tree, device=cuda_device, **sys_kw)
        verdicts = []
        for i, part in enumerate(parts):
            verdicts.append(sys_.run_trace(part)["verdict"])
            if backend == "graph":
                assert sorted(sys_._graphs) == [False, True]
                assert (sys_.capture_s > 0) == (i == 0)
        runs[backend] = (verdicts, sys_, tuple(
            a - b for a, b in zip(_counts(), before)))
        assert sys_.host_syncs == 0
    (v_e, s_e, c_e), (v_g, s_g, c_g) = runs["eager"], runs["graph"]
    assert c_e == c_g and (c_e[0] + c_e[1]) > 0, (c_e, c_g)
    for a, b in zip(v_e, v_g):
        assert np.array_equal(a, b)
    assert s_e.stats == s_g.stats
    for name in ("state", "queues", "_dl"):
        assert_same(getattr(s_e, name), getattr(s_g, name), name)
    if case == "binding":
        assert 0 < s_g.stats["granted"] < 1800
    if case == "tree":
        assert s_g.stats["tree_pkts"] > 0


def test_graph_replay_leaves_the_system_state_alone(cuda_device):
    """After run_trace the system's state is its own: another system's
    graph replays, and this system's next replay, do not move it until
    that replay returns."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    sys_ = FenixSystem(FenixConfig(batch_size=256, control_plane_every=3),
                       _tiny_model(), device=cuda_device)
    assert sys_.step_backend == "graph"
    sys_.run_trace(dict(stream))
    held = sys_.state
    kept = {k: v.clone() for k, v in held.items()}
    sys_.reset()
    sys_.run_trace(dict(stream))
    for k, v in kept.items():
        assert torch.equal(held[k], v), k
    assert_same(held, sys_.state, "a replay from reset repeats itself")


def test_chunk_graphs_recapture_after_the_model_moves(cuda_device):
    """A graph holds the model's addresses: once the model has moved
    (to the host and back) the kept graphs refuse to replay, and the next
    run_trace captures them again and repeats the first run."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    model = _tiny_model()
    sys_ = FenixSystem(FenixConfig(batch_size=256, control_plane_every=3),
                       model, device=cuda_device)
    first = sys_.run_trace(dict(stream))["verdict"]
    stats, graph = dict(sys_.stats), sys_._graphs[False]
    model.to("cpu")
    model.to(cuda_device)
    assert graph.stale()
    with pytest.raises(RuntimeError, match="moved after capture"):
        graph.replay()
    sys_.reset()
    again = sys_.run_trace(dict(stream))["verdict"]
    assert sys_.capture_s > 0 and sys_._graphs[False] is not graph
    assert np.array_equal(first, again) and sys_.stats == stats


def test_decode_graph_recaptures_after_the_weights_move(cuda_device):
    """A weight of the decode graph replaced after capture: the next
    generate captures again and gives the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("llama3.2-1b", reduced=True)
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=6),
                        device=cuda_device)
    first = eng.generate({"tokens": toks})["tokens"]
    key = next(iter(eng.params))
    eng.params[key] = eng.params[key].clone()
    again = eng.generate({"tokens": toks})
    assert again["capture_s"] > 0
    assert torch.equal(first, again["tokens"])


def test_graph_owners_are_freed_without_the_collector(cuda_device):
    """A system and an engine that hold graphs are freed as soon as they
    are dropped: a graph in a reference cycle would be destroyed by the
    garbage collector at any later moment, also during another capture,
    and that invalidates the capture."""
    import gc
    import weakref

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=600)
    sys_ = FenixSystem(FenixConfig(batch_size=256, control_plane_every=2),
                       _tiny_model(), device=cuda_device)
    sys_.run_trace(dict(stream))
    cfg = get_config("llama3.2-1b", reduced=True)
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=3),
                        device=cuda_device)
    eng.generate({"tokens": np.zeros((1, 8), np.int32)})
    assert sys_._graphs and eng._graphs
    refs = (weakref.ref(sys_), weakref.ref(eng))
    gc.disable()
    try:
        del sys_, eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("attn", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_tokens_match_eager(dtype, attn, cuda_device):
    """The decode step replayed as a CUDA graph gives the eager step's
    greedy tokens and kernel counts, over two generate calls on one
    engine (the second reuses the graph)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True),
                              param_dtype=dtype, activation_dtype=dtype)
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    out = {}
    for backend in ("eager", "graph"):
        before = decode_attention_kernel.launches
        eng = ServingEngine(cfg, params, ServeConfig(
            max_new_tokens=6, attn_backend=attn, step_backend=backend),
            device=cuda_device)
        res = [eng.generate({"tokens": toks}) for _ in range(2)]
        out[backend] = [r["tokens"].cpu() for r in res]
        launched = decode_attention_kernel.launches - before
        assert launched == (2 * cfg.num_layers * 5 if attn == "cuda"
                            else 0), backend
        if backend == "graph":
            assert res[0]["capture_s"] > 0 and res[1]["capture_s"] == 0
    for e, g in zip(out["eager"], out["graph"]):
        assert torch.equal(e, g)


# -- decode attention (TPU kernel 4) -----------------------------------------

# (b, hkv, g, d, s): head dims 16..256, groups 1, 4, 5, 8, S not a
# multiple of any tile
_ATTN_SHAPES = [(3, 2, 1, 16, 200), (2, 2, 4, 32, 129), (4, 8, 4, 64, 517),
                (2, 8, 5, 128, 300), (2, 4, 8, 64, 1000),
                (2, 2, 2, 256, 77), (1, 16, 1, 256, 64)]


def _attn_case(rng, b, hkv, g, d, s, q_dtype, kv_dtype, dev, empty=True):
    q = torch.from_numpy(rng.normal(0, 1, (b, hkv * g, d))).to(dev, q_dtype)
    k = torch.from_numpy(rng.normal(0, 1, (b, s, hkv, d))).to(dev, kv_dtype)
    v = torch.from_numpy(rng.normal(0, 1, (b, s, hkv, d))).to(dev, kv_dtype)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    if b > 1:
        lens[-1] = 0 if empty else 1
    if b > 2:
        lens[1] = 1
    return q, k, v, torch.from_numpy(lens.astype(np.int32)).to(dev)


# element by element: 1e-5 in float32; in bfloat16 one ulp of the plain
# output (2^-7 |want|) plus 1e-5, as chip_smoke.py holds it
_ATTN_ULPS = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _attn_excess(got, want, lens):
    """max of |got - want| over its per-element tolerance, over rows with
    keys; rows without keys must be 0."""
    torch.cuda.synchronize()
    full = torch.from_numpy(lens.cpu().numpy() > 0)
    assert torch.all(got[~full] == 0)
    want = want.float()[full]
    diff = (got.float()[full] - want).abs()
    return float((diff / (_ATTN_ULPS[got.dtype] * want.abs() + 1e-5)).max())


def _check_attn(got, want, lens):
    assert _attn_excess(got, want, lens) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _ATTN_SHAPES)
def test_decode_attention_kernel_matches_plain(shape, dtype, cuda_device):
    """The kernel against its plain version on ragged lengths (1, S, an
    empty row, which must give 0), every head dim and group size."""
    rng = np.random.default_rng(sum(shape))
    q, k, v, lens = _attn_case(rng, *shape, dtype, dtype, cuda_device)
    before = decode_attention_kernel.launches
    got = attn_ops.decode_attention(q, k, v, lens, backend="cuda")
    assert decode_attention_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    _check_attn(got, want, lens)


# (b, hkv, g, d, s) for the forced split counts: G = 5 and D = 256 among
# them; lengths S, 1, S/3 and 0, so a row's later splits lie wholly past
# its length
_SPLIT_SHAPES = [(4, 2, 4, 64, 700), (4, 1, 5, 128, 400),
                 (4, 2, 8, 256, 160), (4, 4, 1, 16, 2100)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", _SPLIT_SHAPES)
def test_decode_attention_kernel_split_counts(shape, dtypes, splits,
                                              cuda_device):
    """Every cluster size against the plain version, with splits wholly
    past a row's length; an empty row still gives 0."""
    rng = np.random.default_rng(sum(shape) + splits)
    b, hkv, g, d, s = shape
    q, k, v, lens = _attn_case(rng, *shape, *dtypes, cuda_device)
    lens[2] = s // 3
    before = decode_attention_kernel.launches
    got = decode_attention_kernel(q, k, v, lens, splits=splits)
    assert decode_attention_kernel.launches == before + 1
    _check_attn(got, attn_ops.decode_attention(q, k, v, lens,
                                               backend="ref"), lens)


def test_decode_attention_split_count_from_shapes(cuda_device):
    """The split count at the Llama decode shape is 4 on a 132-SM card,
    and a split count above the tiles of S is refused."""
    from repro_torch.kernels.decode_attention.kernel import (
        num_splits, sm_count, tile_rows)

    if sm_count(cuda_device) == 132:
        assert num_splits(8, 8, 4128, tile_rows(64, 2, True), 132) == 4
    q = torch.zeros(1, 4, 64, device=cuda_device)
    kv = torch.zeros(1, 20, 1, 64, device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="splits"):
        decode_attention_kernel(q, kv, kv, lens, splits=4)


def test_decode_attention_reads_a_layer_of_the_stacked_cache(cuda_device):
    """The kernel reads one layer's view of a [L,B,Smax,Hkv,D] cache in
    place, and a float32 q against a bfloat16 cache (the int8-KV path)."""
    rng = np.random.default_rng(5)
    cache = torch.from_numpy(rng.normal(0, 1, (3, 2, 2, 300, 4, 64))).to(
        cuda_device, torch.bfloat16)            # [L, B, k|v, S, Hkv, D]
    q = torch.from_numpy(rng.normal(0, 1, (2, 16, 64))).to(cuda_device,
                                                            torch.float32)
    lens = torch.tensor([300, 17], dtype=torch.int32, device=cuda_device)
    k, v = cache[1, :, 0], cache[1, :, 1]
    assert not k.is_contiguous()
    got = attn_ops.decode_attention(q, k, v, lens, backend="cuda")
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    _check_attn(got, want, lens)
    for splits in (2, 8):
        _check_attn(decode_attention_kernel(q, k, v, lens, splits=splits),
                    want, lens)


def test_decode_attention_tolerance_catches_a_skipped_tile(cuda_device):
    """The bfloat16 tolerance catches a planted fault: the kernel reading
    every row longer than a tile one 128-row tile short."""
    rng = np.random.default_rng(7)
    q, k, v, lens = _attn_case(rng, 4, 8, 4, 64, 4100, torch.bfloat16,
                               torch.bfloat16, cuda_device, empty=False)
    short = torch.where(lens > 128, lens - 128, lens)
    got = attn_ops.decode_attention(q, k, v, short, backend="cuda")
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    assert _attn_excess(got, want, lens) > 1.0


def test_decode_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(2, 8, 48, device=cuda_device)
    kv = torch.zeros(2, 10, 2, 48, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_kernel(q, kv, kv, lens)
    # any group is taken (G = 9 here), but the query heads must be a
    # multiple of the KV heads
    q = torch.zeros(2, 9, 64, device=cuda_device)
    kv = torch.zeros(2, 10, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of the KV heads"):
        decode_attention_kernel(q, kv, kv, lens)
    q = torch.zeros(2, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention_kernel(q, kv, kv, lens)


# (b, hkv, g, s): groups above one head tile of 8 (a KV head in 2, 2, 2
# and 4 tiles; G = 9 leaves one head in its last tile)
_WIDE_GROUPS = [(3, 2, 9, 300), (2, 3, 12, 517), (4, 1, 16, 2100),
                (2, 2, 32, 160)]


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("shape", _WIDE_GROUPS)
def test_decode_attention_kernel_wide_groups(shape, d, dtypes, splits,
                                             cuda_device):
    """Groups of 9, 12, 16 and 32 query heads (the TPU kernel takes any):
    each KV head's heads in tiles of 8, against the plain version at
    forced split counts, with ragged lengths (S, 1, S/3, an empty row)."""
    from repro_torch.kernels.decode_attention.kernel import (
        head_tiles, tensor_cores, tile_rows)

    b, hkv, g, s = shape
    rng = np.random.default_rng(sum(shape) + d + splits)
    q, k, v, lens = _attn_case(rng, b, hkv, g, d, s, *dtypes, cuda_device)
    if b > 2:
        lens[2] = s // 3
    rows = tile_rows(d, k.element_size(), tensor_cores(*dtypes))
    splits = min(splits, -(-s // rows))     # at most the tiles of S
    assert head_tiles(g) == -(-g // 8)
    before = decode_attention_kernel.launches
    got = decode_attention_kernel(q, k, v, lens, splits=splits)
    assert decode_attention_kernel.launches == before + 1
    assert got.shape == q.shape
    _check_attn(got, attn_ops.decode_attention(q, k, v, lens,
                                               backend="ref"), lens)
    auto = attn_ops.decode_attention(q, k, v, lens, backend="cuda")
    _check_attn(auto, attn_ops.decode_attention(q, k, v, lens,
                                                backend="ref"), lens)


def test_decode_attention_wide_group_catches_a_skipped_tile(cuda_device):
    """At recurrentgemma-9b's group (16 query heads over one KV head, D
    256) the bfloat16 tolerance holds on a full ring of 2048 keys and
    catches the planted fault: every row one 128-row tile short."""
    rng = np.random.default_rng(11)
    q, k, v, lens = _attn_case(rng, 8, 1, 16, 256, 2048, torch.bfloat16,
                               torch.bfloat16, cuda_device, empty=False)
    _check_attn(attn_ops.decode_attention(q, k, v, lens, backend="cuda"),
                attn_ops.decode_attention(q, k, v, lens, backend="ref"),
                lens)
    short = torch.where(lens > 128, lens - 128, lens)
    got = attn_ops.decode_attention(q, k, v, short, backend="cuda")
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    assert _attn_excess(got, want, lens) > 1.0


def test_serving_engine_cuda_matches_ref_on_card(cuda_device):
    """Reduced llama in float32 on the card: the kernel's greedy tokens
    equal the einsum path's, with one launch per layer and step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True),
                              param_dtype="float32",
                              activation_dtype="float32")
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    out = {}
    for backend in ("ref", "cuda"):
        before = decode_attention_kernel.launches
        eng = ServingEngine(cfg, params, ServeConfig(
            max_new_tokens=6, attn_backend=backend), device=cuda_device)
        out[backend] = eng.generate({"tokens": toks})["tokens"].cpu()
        launched = decode_attention_kernel.launches - before
        assert launched == (cfg.num_layers * 5 if backend == "cuda" else 0)
    assert torch.equal(out["ref"], out["cuda"])


# -- the FENIX-RNN, oracle payloads and capture streaming on the card --------


def _rnn_model(lut_preshift=1, seed=0):
    """Random int8 weights in quantize_traffic's RNN layout (tiny RNN),
    held K-major as the serving path holds them."""
    from repro_torch.configs.fenix_models import fenix_rnn_tiny

    cfg = fenix_rnn_tiny()
    rng = np.random.default_rng(seed)
    e, u = cfg.embed_dim, cfg.rnn_units

    def w8(*shape):
        return rng.integers(-127, 128, shape, dtype=np.int8)

    lut = np.clip(np.round(np.tanh(np.arange(-256, 256) / 16) * 128), -127,
                  127).astype(np.int8)
    qp = {"embed_len/table": w8(cfg.len_buckets, e),
          "embed_ipd/table": w8(cfg.ipd_buckets, e),
          "cell/wx": w8(2 * e, u), "cell/wh": w8(u, u),
          "cell/b": rng.integers(-3000, 3000, u, dtype=np.int32),
          "cell/shift_x": 6, "cell/shift_h": 7,
          "cell/lut_preshift": lut_preshift, "tanh_lut": lut,
          "head/w": w8(u, cfg.num_classes),
          "head/b": rng.integers(-500, 500, cfg.num_classes,
                                 dtype=np.int32),
          "head/shift": 0, "cfg_shifts": {}}
    return EngineModel(cfg, qparams_from_numpy(qp))


# the full-width FENIX-RNN's GEMMs at 1024 served lanes: the step's input
# GEMM (K = 32, one k-tile), its recurrent GEMM and the head
@pytest.mark.parametrize("shape", [(1024, 32, 128), (1024, 128, 128),
                                   (1024, 128, 7), (77, 32, 128)])
def test_int8_gemm_at_the_rnn_shapes(shape, cuda_device):
    """Raw int32 output with and without bias (no shift), as the cell
    runs it, and every shift, at max |diff| = 0."""
    rng = np.random.default_rng(sum(shape) + 1)
    m, k, n = shape
    a, b = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)
                             ).to(cuda_device) for s in ((m, k), (k, n)))
    b = mm_ops.k_major(b)
    bias = torch.from_numpy(rng.integers(-40_000, 40_000, n,
                                         dtype=np.int32)).to(cuda_device)
    for shift in (None, 0, 8):
        for bb in (None, bias):
            ref = mm_ops.int8_matmul(a, b, bb, shift, backend="ref")
            got = int8_gemm(a, b, bb, shift)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype
            assert_same(ref, got, f"{shape} shift={shift} bias="
                                  f"{bb is not None}")


def test_cuda_right_shift_by_zero_and_negative_counts(cuda_device):
    """An RNN's lut_preshift may be 0 or negative: ``>>`` by such a count
    on the card gives the CPU's result (a negative count sign-fills)."""
    x = torch.tensor([-5, -4, -1, 0, 3, 2**31 - 1, -2**31],
                     dtype=torch.int32)
    for count in (0, -1, -2, 31, 40):
        want = x >> count
        assert torch.equal((x.to(cuda_device) >> count).cpu(), want), count
        got = x.to(cuda_device) >> torch.full((7,), count, dtype=torch.int32,
                                              device=cuda_device)
        assert torch.equal(got.cpu(), want), count
    assert (x.to(cuda_device) >> -1).cpu().tolist() == [-1, -1, -1, 0, 0, 0,
                                                         -1]


@pytest.mark.parametrize("lut_preshift", [1, 0, -1])
def test_rnn_replay_graph_eager_plain_and_cpu(lut_preshift, cuda_device):
    """The tiny RNN served on the card: graph == eager == plain backends
    == the CPU (verdicts, stats, final tensors), 19 INT8 GEMMs a chunk
    (the tail's included)."""
    stream = packet_stream(make_flows("iscx", 40, seed=7), limit=1800)
    model = _rnn_model(lut_preshift)
    runs = {}
    for name, kw, dev in (("cpu", {}, "cpu"),
                          ("ref", dict(gate_backend="ref",
                                       matmul_backend="ref"), cuda_device),
                          ("eager", dict(step_backend="eager"), cuda_device),
                          ("graph", {}, cuda_device)):
        gemms = int8_gemm.launches
        sys_ = FenixSystem(FenixConfig(batch_size=256,
                                       control_plane_every=3, **kw),
                           model if dev != "cpu" else _rnn_model(
                               lut_preshift).to("cpu"), device=dev)
        runs[name] = (sys_.run_trace(dict(stream))["verdict"], sys_)
        want = 8 * (2 * 9 + 1) if name in ("eager", "graph") else 0
        assert int8_gemm.launches - gemms == want, name
        assert sys_.host_syncs == 0
    v_cpu, s_cpu = runs["cpu"]
    for name in ("ref", "eager", "graph"):
        v, s = runs[name]
        assert np.array_equal(v, v_cpu), name
        assert s.stats == s_cpu.stats, name
        for part in ("state", "queues", "_dl"):
            assert_same(getattr(s_cpu, part), getattr(s, part),
                        f"{name} {part}")
    assert s_cpu.stats["inferences"] > 0


def test_oracle_replay_graph_matches_eager_and_host(cuda_device):
    """Oracle payloads on the card: graph == eager == the host driver
    (fast) == the CPU, over two run_trace calls with ragged tails and a
    third without ``flow_idx`` (the ring's payloads: the graphs are
    captured again without the payload buffer)."""
    flows = make_flows("iscx", 40, seed=7)
    stream = packet_stream(flows, limit=1800)
    oracle = [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
              for f in flows]
    parts = [{k: v[lo:hi] for k, v in stream.items()}
             for lo, hi in ((0, 1100), (1100, 1800))]
    parts.append({k: v for k, v in stream.items() if k != "flow_idx"})
    runs = {}
    for name, kw, dev in (("cpu", {}, "cpu"),
                          ("host", dict(driver="host"), cuda_device),
                          ("eager", dict(step_backend="eager"), cuda_device),
                          ("graph", {}, cuda_device)):
        sys_ = FenixSystem(FenixConfig(batch_size=256,
                                       control_plane_every=3, **kw),
                           _tiny_model(), device=dev, oracle_windows=oracle)
        runs[name] = ([sys_.run_trace(p)["verdict"] for p in parts], sys_)
    v_cpu, s_cpu = runs["cpu"]
    for name in ("host", "eager", "graph"):
        v, s = runs[name]
        for a, b in zip(v, v_cpu):
            assert np.array_equal(a, b), name
        assert s.stats == s_cpu.stats, name
    assert s_cpu.stats["inferences"] > 0


def test_streaming_replay_matches_in_memory_on_card(tmp_path, cuda_device):
    """A pcap streamed in blocks (overlap on and off, and a bare path) on
    a system whose graphs an in-memory replay captured: no new capture,
    0 host syncs, the in-memory replay's verdicts, stats and carry."""
    from repro_torch.data import trace_ingest as ti

    flows = make_flows("iscx", 40, seed=7)
    pcap = tmp_path / "t.pcap"
    source = ti.synthesize_pcap(flows, pcap, limit=2500)
    sys_ = FenixSystem(FenixConfig(batch_size=128, control_plane_every=2),
                       _tiny_model(), device=cuda_device)
    v_mem = sys_.run_trace(dict(source))["verdict"]
    mem = {k: _clone_dict(getattr(sys_, k)) for k in ("state", "queues",
                                                      "_dl")}
    stats = dict(sys_.stats)
    for trace in (ti.TraceSpec(pcap, chunk_pkts=300),
                  ti.TraceSpec(pcap, chunk_pkts=300, overlap=False),
                  str(pcap)):
        sys_.reset()
        before = (fused_gate.launches, int8_gemm.launches)
        v = sys_.run_trace(trace)["verdict"]
        assert (fused_gate.launches - before[0],
                int8_gemm.launches - before[1]) == (20, 60)
        assert np.array_equal(v, v_mem)
        assert sys_.stats == stats
        assert sys_.capture_s == 0.0 and sys_.host_syncs == 0
        for k, d in mem.items():
            assert_same(d, getattr(sys_, k), k)


def _clone_dict(d):
    return {k: v.clone() for k, v in d.items()}


# -- training (the train step's graph, evaluate_quantized's kernel) ----------


def _trainer_pair(name, dev, steps):
    """A graph and an eager trainer of a tiny model from one init, each
    with its batches drawn from the same seed."""
    from repro_torch.configs import fenix_models
    from repro_torch.data.synthetic_traffic import (class_weights,
                                                    windows_from_flows)
    from repro_torch.models import traffic
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           batch_iterator)

    mcfg = getattr(fenix_models, name)()
    x, y, _ = windows_from_flows(make_flows("iscx", 80, seed=3))
    w = class_weights(y, mcfg.num_classes)
    table = traffic.ipd_log2_table(dev)
    params = traffic.init(mcfg, seed=0, device=dev)
    out = {}
    for step in ("graph", "eager"):
        cfg = TrainerConfig(total_steps=steps, log_every=1,
                            step_backend=step,
                            opt=OptConfig(lr=3e-3, warmup_steps=3,
                                          total_steps=steps))
        out[step] = (Trainer(lambda p, b: traffic.loss_fn(p, mcfg, b, table),
                             params, cfg, device=dev),
                     batch_iterator(x, y, 256, seed=1, weights=w,
                                    device=dev))
    return out


@pytest.mark.parametrize("name", ["fenix_cnn_tiny", "fenix_rnn_tiny"])
def test_train_step_graph_matches_eager(name, cuda_device):
    """The train step replayed as a CUDA graph against the same step run
    eagerly, from one init over the same batches: every step's metrics,
    the params, moments and counter bit for bit; then a batch of NaN
    weights leaves the graph trainer's state as it was."""
    pair = _trainer_pair(name, cuda_device, 12)
    for step, (t, batches) in pair.items():
        t.run(batches)
        assert t.step == 12 and t.step_backend == step
    (g, gb), (e, _) = pair["graph"], pair["eager"]
    assert g.capture_s > 0 and e.capture_s == 0
    assert g.metrics_log == e.metrics_log
    assert_same(g.params, e.params)
    assert_same(g.opt_state, e.opt_state)
    before = {"p": {k: v.clone() for k, v in g.params.items()},
              "m": {k: v.clone() for k, v in g.opt_state["m"].items()},
              "step": g.opt_state["step"].clone()}
    saved = gb.data["weight"].clone()
    gb.data["weight"].fill_(float("nan"))
    metrics = g._train_step(gb, next(gb))
    assert torch.isnan(metrics).any()
    assert_same(before, {"p": g.params, "m": g.opt_state["m"],
                         "step": g.opt_state["step"]})
    gb.data["weight"].copy_(saved)
    g.run(gb, steps=2)
    assert g.step == 14 and int(g.opt_state["step"]) == 14


def test_evaluate_quantized_cuda_matches_ref(cuda_device):
    """A tiny CNN trained on the card (the train step's graph by
    default), quantized, and evaluated with the INT8 kernel and with the
    plain backend: the same predictions."""
    from repro_torch.core.model_engine import serving
    from repro_torch.data.synthetic_traffic import windows_from_flows

    mcfg = serving.model_config("int8_rnn_tiny")
    flows = make_flows("iscx", 120, seed=5, min_per_class=10)
    params, qp, m = serving.train_quantized(mcfg, flows, steps=60, seed=5)
    assert all(v.is_cuda for v in params.values())
    x, y, _ = windows_from_flows(flows, seed=9)
    r_k = serving.evaluate_quantized(qp, mcfg, x, y, backend="cuda")
    r_r = serving.evaluate_quantized(qp, mcfg, x, y, backend="ref")
    assert np.array_equal(r_k["pred"], r_r["pred"])
    assert r_k["confusion"] == r_r["confusion"]


# -- MoE serving and the baselines' device paths --------------------------------


def _moe_case(dev, dtype, shape, seed=0):
    """Reduced qwen2-moe routing (60 experts, top 4, 4 shared, gated) at
    d = 64: the MoE config, its params and an input, on ``dev``."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import layers as L
    from repro_torch.models.param import Registrar

    moe = MoEConfig(num_experts=60, top_k=4, expert_d_ff=24,
                    num_shared_experts=4, shared_d_ff=96, shared_gated=True)
    reg = Registrar(seed=seed, dtype=dtype, device="cpu")
    L.init_moe(reg, "moe", 64, moe)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, shape)).to(dtype)
    return moe, {k: v.to(dev) for k, v in reg.params.items()}, x.to(dev)


@pytest.mark.parametrize("shape", [(8, 1, 64), (2, 40, 64)])
def test_moe_ffn_on_card_matches_cpu(shape, cuda_device):
    """``moe_ffn`` in float32 on the card against the CPU: at decode (a
    batch of 8, capacity 1, pairs dropped) and at a prefill shape; within
    1e-5 of the largest output (float32 GEMMs in another order)."""
    from _torch_parity import assert_close
    from repro_torch.models import layers as L

    moe, p, x = _moe_case(cuda_device, torch.float32, shape)
    y, aux = L.moe_ffn(p, "moe", x, moe, "silu")
    pc = {k: v.cpu() for k, v in p.items()}
    y_cpu, aux_cpu = L.moe_ffn(pc, "moe", x.cpu(), moe, "silu")
    assert_close(y_cpu, y, 1e-5)
    assert float(aux) == pytest.approx(float(aux_cpu), rel=1e-5)


def test_moe_combine_is_deterministic(cuda_device):
    """bfloat16 ``moe_ffn`` at decode: two eager calls, and a CUDA-graph
    replay of the same call, bit for bit (the combine adds in a fixed
    order, no atomics)."""
    from repro_torch.models import layers as L

    moe, p, x = _moe_case(cuda_device, torch.bfloat16, (8, 1, 64))
    a = L.moe_ffn(p, "moe", x, moe, "silu")[0]
    b = L.moe_ffn(p, "moe", x, moe, "silu")[0]
    assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L.moe_ffn(p, "moe", x, moe, "silu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = L.moe_ffn(p, "moe", x, moe, "silu")[0]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)


def test_moe_decode_graph_tokens_match_eager(cuda_device):
    """The reduced qwen2-moe model served on the card: decode graph ==
    eager (tokens, decode_attention launches), and float32 card tokens
    == the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 16))
    out = {}
    for backend in ("eager", "graph"):
        before = decode_attention_kernel.launches
        eng = ServingEngine(cfg, params, ServeConfig(
            max_new_tokens=6, step_backend=backend), device=cuda_device)
        out[backend] = eng.generate({"tokens": toks})["tokens"].cpu()
        assert decode_attention_kernel.launches - before == \
            cfg.num_layers * 5
    assert torch.equal(out["eager"], out["graph"])
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    p32, _ = api.init_params(cfg32, seed=0, device="cpu")
    runs = {dev: ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=6),
                               device=dev).generate({"tokens": toks})
            ["tokens"].cpu() for dev in (cuda_device, "cpu")}
    assert torch.equal(runs[cuda_device], runs["cpu"])


def test_baseline_trees_on_card_match_cpu(cuda_device):
    """Leo's depth-10 tree and NetBeacon's forests, fitted once in numpy,
    predict on the card what they predict on the CPU; the forest vote
    breaks three-way ties to the lowest class there too."""
    from repro_torch.baselines.leo import LeoModel
    from repro_torch.baselines.netbeacon import NetBeaconModel, forest_vote

    tr = make_flows("iscx", 200, seed=10, min_per_class=10)
    te = make_flows("iscx", 80, seed=11, min_per_class=5)
    for cls in (LeoModel, NetBeaconModel):
        card, cpu = cls(7, device=cuda_device), cls(7, device="cpu")
        card.fit(tr)
        cpu.fit(tr)
        assert_same(card.predict_packets(te), cpu.predict_packets(te))
    votes = torch.tensor([[5, 1, 2, 4, 0, 6], [3, 1, 6, 4, 6, 6],
                          [0, 2, 4, 1, 6, 6]], device=cuda_device)
    assert forest_vote(votes, 7).tolist() == [0, 1, 2, 4, 6, 6]


# -- the sub-quadratic families (mamba2, recurrentgemma) on the card ---------


def _reduced_engines(arch, device, n_new, **over):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    params, _ = api.init_params(cfg, seed=0, device=device)
    return cfg, {backend: ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, step_backend=backend), device=device)
        for backend in ("eager", "graph")}


@pytest.mark.parametrize("arch,prompt", [("mamba2-370m", 45),
                                         ("recurrentgemma-9b", 20),
                                         ("recurrentgemma-9b", 45)])
def test_subquadratic_decode_graph_tokens_match_eager(arch, prompt,
                                                      cuda_device):
    """Reduced mamba2 and recurrentgemma served on the card: the decode
    graph's tokens, recurrent states, ring and launches equal the eager
    step's over 16 steps (recurrentgemma's 32-slot ring fills from a
    20-token prompt and wraps from a 45-token one)."""
    cfg, engines = _reduced_engines(arch, cuda_device, 17)
    toks = np.random.default_rng(prompt).integers(0, cfg.vocab_size,
                                                  (4, prompt))
    out, caches = {}, {}
    n_attn = sum(k == "attention" for k in cfg.hybrid.pattern) \
        if cfg.family == "hybrid" else 0
    for backend, eng in engines.items():
        before = decode_attention_kernel.launches
        out[backend] = eng.generate({"tokens": toks})["tokens"].cpu()
        assert decode_attention_kernel.launches - before == n_attn * 16
        caches[backend] = eng._decode_bufs[(4, prompt, None)]["cache"]
    assert torch.equal(out["eager"], out["graph"])
    for k, v in caches["eager"].items():
        assert torch.equal(v, caches["graph"][k]), k


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_state_warm_up_leaves_the_state(arch, cuda_device):
    """The warm-up before capture runs on copies of the recurrent states
    (every cache entry without a kv_seq axis): after one replay the cache
    equals the cache after one eager step from the same prefill."""
    cfg, engines = _reduced_engines(arch, cuda_device, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    res = {b: e.generate({"tokens": toks}) for b, e in engines.items()}
    assert res["graph"]["capture_s"] > 0
    assert torch.equal(res["eager"]["tokens"], res["graph"]["tokens"])
    eager = engines["eager"]._decode_bufs[(2, 40, None)]["cache"]
    graph = engines["graph"]._decode_bufs[(2, 40, None)]["cache"]
    assert int(graph["pos"]) == 41
    for k, v in eager.items():
        assert torch.equal(v, graph[k]), k


# -- the cross-attention families (encdec, vlm) on the card ------------------

# (b, hkv, g, d, keys, full): the decode attention's four shapes on the
# seamless-m4t-medium and llama-3.2-vision-11b decode paths (self: a
# 4096-token prompt + 32 new tokens, ragged lengths; cross: every row at
# the full source length, 2048 frames / 4096 image tokens)
_CROSS_SHAPES = [(8, 16, 1, 64, 4128, False), (8, 16, 1, 64, 2048, True),
                 (8, 8, 4, 128, 4128, False), (8, 8, 4, 128, 4096, True)]


@pytest.mark.parametrize("shape", _CROSS_SHAPES)
def test_decode_attention_at_the_cross_attention_shapes(shape, cuda_device):
    """bfloat16 at each new main-path shape: within one ulp of the plain
    output + 1e-5, and the planted fault (every row one 128-row tile
    short) breaks that bound."""
    b, hkv, g, d, s, full = shape
    rng = np.random.default_rng(s + d + g)
    q, k, v, lens = _attn_case(rng, b, hkv, g, d, s, torch.bfloat16,
                               torch.bfloat16, cuda_device, empty=False)
    if full:
        lens.fill_(s)
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    before = decode_attention_kernel.launches
    _check_attn(attn_ops.decode_attention(q, k, v, lens, backend="cuda"),
                want, lens)
    assert decode_attention_kernel.launches == before + 1
    short = torch.where(lens > 128, lens - 128, lens)
    got = attn_ops.decode_attention(q, k, v, short, backend="cuda")
    assert _attn_excess(got, want, lens) > 1.0


def _cross_batch(cfg, b, s, s_src, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    shape = (b, s_src if cfg.family == "encdec" else cfg.num_image_tokens,
             cfg.d_model)
    batch["src_embeds" if cfg.family == "encdec" else "image_embeds"] = \
        rng.normal(0, 1, shape).astype(np.float32)
    return batch


def _gates_at(params, gate):
    return {k: (torch.full_like(v, gate) if k.endswith(
        ("gate_attn", "gate_mlp")) else v) for k, v in params.items()}


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_cross_attention_decode_graph_tokens_match_eager(arch, cuda_device):
    """Reduced seamless-m4t (a 13-frame source) and llama-3.2-vision (2
    superblocks, gates 0.5) served on the card: the decode graph's tokens,
    caches and launches (self and cross attention, every layer, every
    step) equal the eager step's over 16 steps, and the float32 tokens
    equal the CPU's."""
    import dataclasses

    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    over = {"num_layers": 10} if arch.startswith("llama") else {}
    cfg, engines = _reduced_engines(arch, cuda_device, 17, **over)
    params = _gates_at(engines["eager"].params, 0.5)
    engines = {b: ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=17, step_backend=b), device=cuda_device)
        for b in ("eager", "graph")}
    batch = _cross_batch(cfg, 4, 40, 13, 5)
    per_step = 2 * cfg.num_decoder_layers if cfg.family == "encdec" \
        else cfg.num_layers
    out, caches = {}, {}
    for backend, eng in engines.items():
        before = decode_attention_kernel.launches
        out[backend] = eng.generate(batch)["tokens"].cpu()
        assert decode_attention_kernel.launches - before == per_step * 16
        (key,) = eng._decode_bufs
        caches[backend] = eng._decode_bufs[key]["cache"]
    assert torch.equal(out["eager"], out["graph"])
    for k, v in caches["eager"].items():
        assert torch.equal(v, caches["graph"][k]), k
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              activation_dtype="float32")
    p32, _ = api.init_params(f32, seed=0, device="cpu")
    p32 = _gates_at(p32, 0.5)
    runs = {dev: ServingEngine(f32, p32, ServeConfig(max_new_tokens=9),
                               device=dev).generate(batch)["tokens"].cpu()
            for dev in ("cpu", cuda_device)}
    assert torch.equal(runs["cpu"], runs[cuda_device])


def test_two_source_lengths_get_their_own_graphs(cuda_device):
    """Reduced seamless-m4t on the decode graph: requests with 11- and
    17-frame sources, in turns, capture one graph each and reuse it, and
    each request's tokens equal a fresh engine's."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg, engines = _reduced_engines("seamless-m4t-medium", cuda_device, 6)
    eng = engines["graph"]
    captures = []
    for seed, s_src in ((1, 11), (2, 17), (3, 11), (4, 17)):
        batch = _cross_batch(cfg, 2, 12, s_src, seed)
        res = eng.generate(batch)
        captures.append(res["capture_s"] > 0)
        fresh = ServingEngine(cfg, eng.params, ServeConfig(
            max_new_tokens=6), device=cuda_device).generate(batch)
        assert torch.equal(res["tokens"], fresh["tokens"])
    assert captures == [True, True, False, False]
    assert sorted(eng._graphs) == [(2, 12, 11), (2, 12, 17)]
    for key, bufs in eng._decode_bufs.items():
        assert bufs["cache"]["dec/xk"].shape[2] == key[2]


# -- MLA (deepseek-v2) and recurrentgemma's long_500k on the card ------------


def test_mla_decode_graph_tokens_match_eager_and_cpu(cuda_device):
    """Reduced deepseek-v2 (MLA over MoE blocks) served on the card: the
    decode graph's tokens and latent caches equal the eager step's over
    16 steps, with no kernel of the port launched (the absorbed decode
    is plain torch ops, as the reference's is plain einsums), and the
    float32 tokens equal the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg, engines = _reduced_engines("deepseek-v2-236b", cuda_device, 17)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 40))
    out, caches = {}, {}
    for backend, eng in engines.items():
        before = decode_attention_kernel.launches
        out[backend] = eng.generate({"tokens": toks})["tokens"].cpu()
        assert decode_attention_kernel.launches == before
        caches[backend] = eng._decode_bufs[(4, 40, None)]["cache"]
    assert torch.equal(out["eager"], out["graph"])
    assert sorted(caches["graph"]) == ["layer0/ckv", "layer0/kpe", "pos",
                                       "scan/ckv", "scan/kpe"]
    for k, v in caches["eager"].items():
        assert torch.equal(v, caches["graph"][k]), k
    f32 = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True),
                              param_dtype="float32",
                              activation_dtype="float32")
    p32, _ = api.init_params(f32, seed=0, device="cpu")
    runs = {dev: ServingEngine(f32, p32, ServeConfig(max_new_tokens=9),
                               device=dev).generate({"tokens": toks})
            ["tokens"].cpu() for dev in ("cpu", cuda_device)}
    assert torch.equal(runs["cpu"], runs[cuda_device])


@pytest.mark.parametrize("seg", [24, 16, 40])
def test_segmented_prefill_on_card_matches_whole(seg, cuda_device,
                                                 monkeypatch):
    """Reduced recurrentgemma (float32) on the card: a 100-token prompt
    prefilled in segments of ``seg`` positions (PREFILL_TOKENS patched)
    against the whole-prompt prefill: logits and every cache entry (the
    ring in slot order, conv tails, states) within 1e-5 of the largest
    (the scan's tree and the attention's blocks differ by segment), and
    the greedy tokens of 8 decode steps equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import recurrentgemma as rg
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True),
                              param_dtype="float32",
                              activation_dtype="float32")
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(seg).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)).to(cuda_device)
    runs = {}
    for name, budget in (("whole", 1 << 16), ("segmented", 2 * seg)):
        monkeypatch.setattr(rg, "PREFILL_TOKENS", budget)
        cache, logits = api.prefill(params, cfg, {"tokens": toks})
        gen = ServingEngine(cfg, params, ServeConfig(max_new_tokens=9),
                            device=cuda_device).generate({"tokens": toks})
        runs[name] = cache, logits, gen["tokens"].cpu()
    (cw, lw, tw), (cs, ls, ts) = runs["whole"], runs["segmented"]
    for want, got, what in [(lw, ls, "logits")] + [
            (cw[k], cs[k], k) for k in cw if k != "pos"]:
        err = float((want - got).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (what, err)
    assert torch.equal(tw, ts)


def test_decode_attention_at_the_long_500k_shape(cuda_device):
    """recurrentgemma-9b's long_500k decode: batch 1, 16 query heads over
    one KV head, D 256, the full 2048-slot ring, bfloat16: within one ulp
    of the plain output + 1e-5, and the planted fault (the row one
    128-row tile short) breaks that bound."""
    rng = np.random.default_rng(500)
    q, k, v, lens = _attn_case(rng, 1, 1, 16, 256, 2048, torch.bfloat16,
                               torch.bfloat16, cuda_device, empty=False)
    lens.fill_(2048)
    want = attn_ops.decode_attention(q, k, v, lens, backend="ref")
    before = decode_attention_kernel.launches
    _check_attn(attn_ops.decode_attention(q, k, v, lens, backend="cuda"),
                want, lens)
    assert decode_attention_kernel.launches == before + 1
    got = attn_ops.decode_attention(q, k, v, lens - 128, backend="cuda")
    assert _attn_excess(got, want, lens) > 1.0


# -- LM training ---------------------------------------------------------------

_TRAIN_VARIANTS = [("llama3.2-1b", None), ("qwen2-moe-a2.7b", None),
                   ("deepseek-v2-236b", None), ("mamba2-370m", None),
                   ("recurrentgemma-9b", None), ("seamless-m4t-medium", None),
                   ("llama-3.2-vision-11b", 0.5)]


def _train_case(arch, gate=None, dtype="float32", seed=0):
    """The reduced config in ``dtype``, its CPU params (cross gates at
    ``gate``) and a batch of 2 x 32 tokens (encdec's source and vlm's
    image float32 normals)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype=dtype, activation_dtype=dtype)
    params, _ = api.init_params(cfg, seed=seed, device="cpu")
    if gate is not None:
        params = {k: (torch.full_like(v, gate) if k.endswith(
            ("gate_attn", "gate_mlp")) else v) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    batch = next(token_batches(cfg.vocab_size, 2, 32, seed=seed))
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((2, 24, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)
    return cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,gate", _TRAIN_VARIANTS)
def test_lm_loss_and_grads_on_card_match_cpu(arch, gate, cuda_device):
    """``api.loss_fn`` and its gradients on the card against the CPU
    (float32, reduced): the loss within 1e-5 relative, each gradient
    leaf within 1e-4 of its largest magnitude (cuBLAS's and the
    embedding's sorted backward's summation orders)."""
    from repro_torch.models import api
    from repro_torch.train.optimizer import value_and_grad

    cfg, params, batch = _train_case(arch, gate)
    res = {}
    for dev in ("cpu", cuda_device):
        res[str(dev)] = value_and_grad(
            lambda p, b: api.loss_fn(p, cfg, b),
            {k: v.to(dev) for k, v in params.items()},
            {k: v.to(dev) for k, v in batch.items()})
    (lc, mc, gc), (lg, mg, gg) = res["cpu"], res[str(cuda_device)]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    assert sorted(mg) == sorted(mc)
    for k in gc:
        ref = gc[k].double()
        err = float((gg[k].cpu().double() - ref).abs().max())
        assert err <= 1e-4 * max(float(ref.abs().max()), 1e-30), (k, err)


def test_lm_bf16_head_backward_on_card(cuda_device):
    """The bfloat16 logits head on the card (``matmul_f32``'s
    ``_MatmulF32``: a GEMM with float32 output) differentiates, and its
    operand gradients equal the cast path's autograd (float32 operands)
    within 1e-6 of the largest; a reduced bf16 llama's loss on the card
    within 2e-2 relative of the CPU's (bf16 roundings in another GEMM
    order), its gradients finite and bf16."""
    from repro_torch.models import api
    from repro_torch.models.layers import matmul_f32
    from repro_torch.train.optimizer import value_and_grad

    gen = torch.Generator(device="cpu").manual_seed(0)
    x0 = torch.randn(96, 64, generator=gen).bfloat16().to(cuda_device)
    t0 = torch.randn(512, 64, generator=gen).bfloat16().to(cuda_device)
    g = torch.randn(96, 512, generator=gen).to(cuda_device)
    x, t = x0.clone().requires_grad_(), t0.clone().requires_grad_()
    matmul_f32(x, t.t()).backward(g)
    x2, t2 = x0.clone().requires_grad_(), t0.clone().requires_grad_()
    torch.matmul(x2.float(), t2.t().float()).backward(g)
    for a, b in ((x.grad, x2.grad), (t.grad, t2.grad)):
        assert a.dtype == torch.bfloat16
        ref = b.float()
        assert float((a.float() - ref).abs().max()) <= \
            1e-6 * float(ref.abs().max())
    cfg, params, batch = _train_case("llama3.2-1b", dtype="bfloat16")
    lc, _, _ = value_and_grad(lambda p, b: api.loss_fn(p, cfg, b), params,
                              batch)
    lg, _, gg = value_and_grad(
        lambda p, b: api.loss_fn(p, cfg, b),
        {k: v.to(cuda_device) for k, v in params.items()},
        {k: v.to(cuda_device) for k, v in batch.items()})
    assert abs(float(lg) - float(lc)) <= 2e-2 * abs(float(lc))
    for k, v in gg.items():
        assert v.dtype == params[k].dtype and bool(torch.isfinite(v).all())


def test_lm_train_graph_step_matches_eager(cuda_device):
    """The port's ``Trainer`` over ``api.loss_fn`` (reduced llama3.2-1b,
    bf16 params, remat "nothing") on the train step's graph against the
    eager step, from one init over the launcher's batches: every step's
    metrics, the params, moments and counter bit for bit."""
    from repro_torch.launch.train import token_batches
    from repro_torch.models import api
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, params, _ = _train_case("llama3.2-1b", dtype="bfloat16")
    batches = list(itertools.islice(token_batches(cfg.vocab_size, 2, 64), 4))
    out = {}
    for step in ("graph", "eager"):
        t = Trainer(lambda p, b: api.loss_fn(p, cfg, b), params,
                    TrainerConfig(opt=OptConfig(warmup_steps=1,
                                                total_steps=4),
                                  step_backend=step), device=cuda_device)
        out[step] = (t, [t.train_step(batches, b) for b in batches])
    (g, mg), (e, me) = out["graph"], out["eager"]
    assert g.capture_s > 0 and mg == me
    _equal_trees(g.params, e.params)
    _equal_trees(g.opt_state, e.opt_state)


def _equal_trees(a, b, where=""):
    """Nested dicts of tensors (bfloat16 too) equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
        return
    assert a.dtype == b.dtype and torch.equal(a, b), where


# the peak allocation above the parameters of a warmed-up prefill of the
# reduced mamba2-370m (chunk 64, batch 4 x 2048) with the in-place SSD as
# it stood before the gradient path was added, read on an NVIDIA H100
# 80GB HBM3 (torch 2.11.0+cu128); the current code reads the same
MAMBA2_PREFILL_PEAK = 56_402_432


def test_mamba2_serving_prefill_allocates_as_before(cuda_device):
    """mamba2's serving prefill allocates no more than the in-place SSD
    did before the gradient path existed (a fixed reading at this
    shape); the out-of-place path, forced, gives the same bits, and a
    prefill under autograd, which takes it, holds more."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("mamba2-370m", reduced=True),
                              ssm=dataclasses.replace(
                                  get_config("mamba2-370m", reduced=True).ssm,
                                  chunk_size=64))
    params, _ = api.init_params(cfg, seed=0, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048),
                           device=cuda_device, dtype=torch.int32)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    def serve():
        return api.prefill(params, cfg, {"tokens": tokens})

    with torch.no_grad():
        serve()                 # the libraries' one-time workspaces
        served, (c1, l1) = peak(serve)
        tracked = L._tracked
        try:
            L._tracked = lambda *xs: True
            _, (c2, l2) = peak(serve)
        finally:
            L._tracked = tracked
    assert served <= MAMBA2_PREFILL_PEAK, (served, MAMBA2_PREFILL_PEAK)
    assert torch.equal(l1, l2)
    _equal_trees(c1, c2)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    graded, (_, l3) = peak(lambda: api.prefill(leaves, cfg,
                                               {"tokens": tokens}))
    assert torch.equal(l3.detach(), l1) and graded > served


def test_decode_attention_op_on_card_and_meta(cuda_device):
    """Kernel 4 through its custom op: one launch counted a call on the
    card, the same output as a call with explicit splits' default, and a
    meta call of the same shapes gives the kernel's output shape and
    dtype with no launch."""
    rng = np.random.default_rng(3)
    b, hkv, g, d, s = 4, 2, 4, 128, 777
    q = torch.from_numpy(rng.standard_normal((b, hkv * g, d), np.float32)) \
        .to(cuda_device, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d), np.float32)) \
        .to(cuda_device, torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d), np.float32)) \
        .to(cuda_device, torch.bfloat16)
    lens = torch.tensor([1, 100, 777, 400], dtype=torch.int32,
                        device=cuda_device)
    before = decode_attention_kernel.launches
    out = torch.ops.repro_torch.decode_attention(q, k, v, lens, 0)
    again = decode_attention_kernel(q, k, v, lens)
    assert decode_attention_kernel.launches == before + 2
    assert torch.equal(out, again)
    meta = decode_attention_kernel(*(x.to("meta") for x in (q, k, v, lens)))
    assert meta.is_meta and meta.shape == out.shape \
        and meta.dtype == out.dtype
    assert decode_attention_kernel.launches == before + 2


def test_reference_call_forms_on_card_match_cpu(cuda_device):
    """The reference's call forms on the card: ``decode_attention``'s
    positional ``ck`` launches the kernel once and changes no bit; the
    window rollovers in the reference's signatures give, on a stacked
    state on the card, what they give on a CPU copy."""
    from repro_torch.core.data_engine import flow_tracker as ft
    from repro_torch.core.data_engine import rate_limiter as rl
    from repro_torch.core.data_engine import state as st

    rng = np.random.default_rng(5)
    b, hkv, g, d, s = 4, 2, 4, 64, 1500
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, torch.bfloat16)
               for shape in ((b, hkv * g, d), (b, s, hkv, d),
                             (b, s, hkv, d)))
    lens = torch.tensor([1, 700, 1500, 1024], dtype=torch.int32,
                        device=cuda_device)
    want = attn_ops.decode_attention(q, k, v, lens)
    before = decode_attention_kernel.launches
    for ck in (1, 256, s + 1):
        assert torch.equal(attn_ops.decode_attention(q, k, v, lens, ck),
                           want)
    assert decode_attention_kernel.launches == before + 3
    with pytest.raises(ValueError, match="ck"):
        attn_ops.decode_attention(q, k, v, lens, 0)

    p = 4
    lcfg = st.local_engine_config(st.EngineConfig(n_slots_log2=8), p)
    card = st.init_pipes_state(lcfg, p, device=cuda_device)
    for key, hi in (("flow_cnt", 500), ("win_pkt_cnt", 50_000),
                    ("t_last", 10**7)):
        card[key] = torch.from_numpy(
            rng.integers(0, hi, p).astype(np.int32)).to(cuda_device)
    host = {key: t.cpu() for key, t in card.items()}
    now = card["t_last"][2]
    assert_same(ft.window_reset(host, lcfg, now.cpu()),
                ft.window_reset(card, lcfg, now))
    assert_same(ft.window_reset_pipes(host, lcfg),
                ft.window_reset_pipes(card, lcfg))
    assert_same(rl.control_plane_update_pipes(host, lcfg, p),
                rl.control_plane_update_pipes(card, lcfg, p))


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "decode"),
                                       ("llama3.2-1b", "train"),
                                       ("qwen2-moe-a2.7b", "prefill")])
def test_dry_run_peak_matches_card(arch, kind, cuda_device):
    """A reduced step traced on meta along the card's path and run on the
    card from the same ``build_step``: the traced peak of the step's own
    allocations within 10% of ``max_memory_allocated``'s rise (after a
    warm-up step, the inputs in place)."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    name = {"decode": "decode_32k", "train": "train_4k",
            "prefill": "prefill_32k"}[kind]
    shape = dataclasses.replace(SHAPES[name], global_batch=4, seq_len=512)
    cfg = get_config(arch, reduced=True)
    step, args, _ = dryrun.build_step(cfg, shape)
    _, counts = dryrun.trace(step, args)
    gen = torch.Generator().manual_seed(0)

    def real(x):
        if isinstance(x, dict):
            return {k: real(v) for k, v in x.items()}
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=gen) * 0.02).to(
                cuda_device, x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype, device=cuda_device)

    card = tuple(real(a) for a in args)
    out = step(*card)
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    assert abs(counts["temp_bytes"] - peak) <= 0.10 * peak, \
        (counts["temp_bytes"], peak)
