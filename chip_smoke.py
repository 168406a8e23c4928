"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed S] [--packets N] [--model-dir DIR]

Phases, in order; any failure exits non-zero and no phase catches one:

1. Environment: torch and CUDA versions, the card's name and power
   limit, and the build of every hand-written kernel from this
   checkout's sources (one nvcc per source, all at once, one library).
2. Kernels against their plain PyTorch versions on the card: the fused
   admission gate at several batch sizes (random LUTs, bucket states,
   ragged batches) and the INT8 GEMM at the serving path's six shapes
   plus ragged ones, with and without bias, shift in {None, 0, 7}.  The
   tolerance is exact equality (max |diff| = 0): every output is an
   integer.  Each kernel is timed beside its plain version and, for the
   GEMM, beside ``torch._int_mm``.
3. The slice: a ~2^18-packet synthetic ISCX trace replayed by
   ``FenixSystem`` on the single-pipe device driver, serving the
   full-width INT8 FENIX-CNN (conv 64/128/256, FC 512/256, embed 16,
   seq 9) with random int8 weights made from ``--seed`` (or a reference
   checkpoint from ``--model-dir``).  The replay's chunk loop runs under
   ``torch.cuda.set_sync_debug_mode("error")``.  The same replay with
   ``gate_backend="ref", matmul_backend="ref"`` on the card must give
   identical verdicts and stats, and a prefix replayed on the CPU must
   agree with the card.  One more replay runs under torch.profiler: the
   device's busy time and idle share, the top kernels, the host ops.
4. The ``kernels`` JSON line, then the last line:
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It imports the port (``src/repro_torch``) and never JAX or ``repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its
# operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate
GATE_OPS_PER_LANE = 12            # shifts, clamps, gather, compares, scan


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packets", type=int, default=1 << 18)
    ap.add_argument("--model-dir", default=None,
                    help="serve a reference save_quantized checkpoint "
                         "instead of seeded random weights")
    return ap.parse_args()


def host_ms(fn, iters=30, warmup=3):
    """Milliseconds per eager call, back to back, CUDA events: the
    host's launch overhead shows here when it exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, reps=5):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times, so no host launch gap is counted.
    Inputs stay L2-resident across calls, as they do in the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def require(ok, what):
    """A check of this run's results (kept under python -O, unlike
    assert): raises when ``ok`` is false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_abs_diff(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
               if a.numel() else 0)


# -- phase 1 ----------------------------------------------------------------

def phase_environment():
    from repro_torch.kernels import _build

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0].strip())
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"capability={torch.cuda.get_device_capability(0)}")
    seconds, log = _build.build_all(ptxas_verbose=True)
    print(f"kernel build: {seconds:.2f} s ({len(_build.SOURCES)} sources "
          "compiled in parallel, one library)")
    print(log)
    x = torch.tensor([-5, -4, -1, 7, -2**31], dtype=torch.int32,
                     device="cuda")
    got = (x >> 1).cpu().tolist()
    require(got == [-3, -2, -1, 3, -2**30], f"int32 >> gave {got}")
    print("int32 >> on the card floors negative values: ok")


# -- phase 2 ----------------------------------------------------------------

def _gate_case(rng, n, dev, cost, cap):
    lut = rng.integers(0, 1 << 16, (64, 32)).astype(np.int32)
    lut[rng.random((64, 32)) < 0.2] = 0
    ts = np.sort(rng.integers(10_000, 10_000 + 3 * n, n)).astype(np.int32)
    t_last = 0 if rng.random() < 0.25 else int(ts[0] - rng.integers(0, 99))
    arrs = dict(t_i=rng.integers(0, 70_000, n), c_i=rng.integers(0, 40, n),
                ts=ts, rand16=rng.integers(0, 1 << 16, n), lut=lut,
                bucket=np.int32(rng.integers(0, 2 * cap)),
                t_last=np.int32(t_last))
    return {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
            for k, v in arrs.items()}


def _gate_bound_ms(n):
    byts = n * (4 * 4 + 1) + 64 * 32 * 4 + 2 * 4 + 4
    return max(byts / HBM_BYTES_PER_S,
               n * GATE_OPS_PER_LANE / SCALAR_OPS_PER_S) * 1e3


def phase_gate(rng):
    from repro_torch.kernels.rate_gate.kernel import fused_gate
    from repro_torch.kernels.rate_gate.ops import fused_admission
    from repro_torch.kernels.rate_gate.ref import fused_admission_ref

    cost, cap = 2, 128
    worst = 0
    for n in (1, 256, 1000, 4059, 4096, 8192):
        for trial in range(8):
            c = _gate_case(rng, n, "cuda", cost, cap)
            res = [fused_admission(
                c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"], rand16=c["rand16"], cost_us=cost,
                bucket_cap_us=cap, backend=backend)
                for backend in ("ref", "cuda")]
            worst = max(worst, max_abs_diff(res[0][0], res[1][0]),
                        max_abs_diff(res[0][1], res[1][1]))
        print(f"fused_gate n={n}: max|diff|={worst} "
              f"granted={int(res[1][0].sum())}/{n}")
    require(worst == 0, f"fused_gate vs plain max|diff| {worst}")
    out = {}
    for n in (256, 4096, 8192):
        c = _gate_case(rng, n, "cuda", cost, cap)
        t_ref = torch.where(c["t_last"] == 0, c["ts"][0], c["t_last"])
        burst0 = torch.clamp_max(c["bucket"], cap)
        scal = torch.stack([burst0, t_ref])
        kw = dict(t_shift=10, c_shift=0, cost_us=cost, bucket_cap_us=cap)

        def kern():
            return fused_gate(c["t_i"], c["c_i"], c["ts"], c["rand16"],
                              c["lut"], scal, **kw)

        def plain():
            return fused_admission_ref(c["t_i"], c["c_i"], c["ts"],
                                       c["lut"], c["rand16"], burst0, t_ref,
                                       10, 0, cost, cap)

        ms, plain_ms = device_ms(kern), device_ms(plain)
        bound = _gate_bound_ms(n)
        print(f"fused_gate n={n}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
              f"ms (device time, graph replay); eager per call "
              f"{host_ms(kern):.5f} / {host_ms(plain):.5f} ms; bound "
              f"{bound:.6f} ms (bytes); no library call; launches so far "
              f"{fused_gate.launches}")
        out[n] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": "bytes",
                  "library_ms": None}
    return out[4096]


# the six GEMMs of one chunk of the full-width CNN: 1024 served lanes x 9
PATH_GEMMS = (("conv0", 9216, 96, 64, 7), ("conv1", 9216, 192, 128, 7),
              ("conv2", 9216, 384, 256, 7), ("fc0", 1024, 256, 512, 7),
              ("fc1", 1024, 512, 256, 7), ("head", 1024, 256, 7, None))


def _gemm_bound_ms(m, k, n, shift):
    byts = m * k + k * n + 4 * n + m * n * (1 if shift is not None else 4)
    t_bytes = byts / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_gemm(rng):
    from repro_torch.kernels.int8_matmul.kernel import int8_gemm
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    def operands(m, k, n):
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        bias = torch.from_numpy(rng.integers(-50_000, 50_000, n,
                                             dtype=np.int32))
        return a.cuda(), b.cuda(), bias.cuda()

    worst = 0
    shapes = [s[1:4] for s in PATH_GEMMS] + [(1, 1, 1), (17, 33, 9),
                                             (1000, 100, 70),
                                             (4099, 200, 130)]
    for m, k, n in shapes:
        a, b, bias = operands(m, k, n)
        for shift in (None, 0, 7):
            for bb in (None, bias):
                ref = int8_matmul(a, b, bb, shift, backend="ref")
                got = int8_matmul(a, b, bb, shift, backend="cuda")
                worst = max(worst, max_abs_diff(got, ref))
        neg = int((int8_matmul(a, b, None, None, backend="cuda") < 0)
                  .sum())
        print(f"int8_gemm [{m},{k}]x[{k},{n}]: max|diff|={worst} "
              f"negative accumulators={neg}")
    require(worst == 0, f"int8_gemm vs plain max|diff| {worst}")
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    by = set()
    for name, m, k, n, shift in PATH_GEMMS:
        a, b, bias = operands(m, k, n)
        # torch._int_mm (the raw int32 product only) needs N % 8 == 0:
        # the head's 7 columns are padded to 8 for the yardstick
        b_lib = b if n % 8 == 0 else torch.nn.functional.pad(
            b, (0, 8 - n % 8))

        def kern():
            return int8_gemm(a, b, bias, shift)

        def plain():
            return int8_matmul_ref(a, b, bias, shift)

        def lib():
            return torch._int_mm(a, b_lib)

        ms, plain_ms, lib_ms = device_ms(kern), device_ms(plain), \
            device_ms(lib)
        bound, bb = _gemm_bound_ms(m, k, n, shift)
        by.add(bb)
        print(f"int8_gemm {name} [{m},{k}]x[{k},{n}]: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, torch._int_mm {lib_ms:.5f} ms "
              f"(device time, graph replay); eager kernel call "
              f"{host_ms(kern):.5f} ms; bound {bound:.6f} ms ({bb})")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound), ("library_ms", lib_ms)):
            total[key] += v
    print(f"int8_gemm per chunk (six GEMMs): kernel {total['ms']:.5f} ms, "
          f"plain {total['plain_ms']:.5f} ms, torch._int_mm "
          f"{total['library_ms']:.5f} ms, bound {total['bound_ms']:.6f} ms; "
          f"launches so far {int8_gemm.launches}")
    return {"max_abs_err": worst, **total,
            "bound_by": "bytes" if by == {"bytes"} else "operations"}


# -- phase 3 ----------------------------------------------------------------

def _calib_windows(flows, n_win, win):
    out = []
    for f in flows:
        feats = np.stack([f.pkt_len, f.ipd_us], axis=-1).astype(np.int32)
        for e in range(win - 1, len(feats), 7):
            out.append(feats[e + 1 - win:e + 1])
            if len(out) == n_win:
                return np.stack(out)
    return np.stack(out)


def seeded_qparams(mcfg, seed, calib):
    """Random int8 weights in ``quantize_traffic``'s layout, with each
    layer's requantization shift chosen on a calibration batch so that
    the 99th percentile of |accumulator| lands near 64: activations
    neither vanish nor all saturate.  The head's bias centres the
    classes' logits on the same batch."""
    from repro_torch.kernels.int8_matmul.ops import int8_conv1d, int8_matmul
    from repro_torch.models.traffic import bucketize

    rng = np.random.default_rng(seed)
    e = mcfg.embed_dim

    def w8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def pick_shift(acc):
        q = float(np.percentile(np.abs(acc.numpy()), 99))
        return max(0, math.ceil(math.log2(max(q, 1.0) / 64.0)))

    qp = {"embed_len/table": w8(mcfg.len_buckets, e),
          "embed_ipd/table": w8(mcfg.ipd_buckets, e)}
    shifts = {"embed": 0}
    ids = bucketize(torch.from_numpy(calib), mcfg).long()
    x = torch.cat([torch.from_numpy(qp["embed_len/table"])[ids[..., 0]],
                   torch.from_numpy(qp["embed_ipd/table"])[ids[..., 1]]],
                  dim=-1)

    def layer(name, w, conv):
        nonlocal x
        fn = int8_conv1d if conv else int8_matmul
        acc = fn(x, torch.from_numpy(w), None, None, backend="ref")
        scale = int(np.median(np.abs(acc.numpy()))) + 1
        b = rng.integers(-scale, scale + 1, w.shape[-1]).astype(np.int32)
        acc = acc + torch.from_numpy(b)
        shift = pick_shift(acc)
        qp[f"{name}/w"], qp[f"{name}/b"], qp[f"{name}/shift"] = w, b, shift
        shifts[name] = shift
        x = torch.clamp_min(fn(x, torch.from_numpy(w), torch.from_numpy(b),
                               shift, backend="ref"), 0)

    c_prev = 2 * e
    for i, ch in enumerate(mcfg.conv_filters):
        layer(f"conv{i}", w8(mcfg.conv_kernel, c_prev, ch), conv=True)
        c_prev = ch
    qp["pool/mult"] = np.int32(round((1 << 15) / mcfg.seq_len))
    xs = x.to(torch.int32).sum(dim=1, dtype=torch.int32)
    x = ((xs * int(qp["pool/mult"])) >> 15).to(torch.int8)
    f_prev = c_prev
    for i, fc in enumerate(mcfg.fc_dims):
        layer(f"fc{i}", w8(f_prev, fc), conv=False)
        f_prev = fc
    head = w8(f_prev, mcfg.num_classes)
    acc = int8_matmul(x, torch.from_numpy(head), None, None, backend="ref")
    qp["head/w"] = head
    # centre each class's logit on the calibration batch, so the argmax
    # is not one class's constant offset
    qp["head/b"] = (-acc.to(torch.float64).mean(dim=0)).round().numpy() \
        .astype(np.int32)
    qp["head/shift"] = 0
    qp["cfg_shifts"] = shifts
    return qp


def replay(model, stream, device, batch, cpe, **backends):
    from repro_torch.core.fenix import FenixConfig, FenixSystem

    sys_ = FenixSystem(FenixConfig(model="int8_cnn", batch_size=batch,
                                   control_plane_every=cpe, **backends),
                       model, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sys_.run_trace(stream)            # returns host arrays: synced
    return out["verdict"], sys_, time.perf_counter() - t0


def phase_slice(args):
    from repro_torch.configs.fenix_models import fenix_cnn
    from repro_torch.core.model_engine import serving
    from repro_torch.core.model_engine.inference import EngineModel
    from repro_torch.data.synthetic_traffic import make_flows, packet_stream
    from repro_torch.kernels.int8_matmul.kernel import int8_gemm
    from repro_torch.kernels.rate_gate.kernel import fused_gate

    batch, cpe = 4096, 8
    t0 = time.perf_counter()
    flows = make_flows("iscx", max(64, args.packets // 200),
                       seed=args.seed)
    stream = packet_stream(flows, limit=args.packets)
    n = len(stream["ts_us"])
    print(f"trace: {n} packets from {len(flows)} flows "
          f"({time.perf_counter() - t0:.1f} s to make)")
    if args.model_dir:
        qp, mcfg = serving.load_quantized(args.model_dir)
    else:
        mcfg = fenix_cnn()
        qp = seeded_qparams(mcfg, args.seed, _calib_windows(flows, 512, 9))
    print(f"model: {mcfg.name} conv={mcfg.conv_filters} fc={mcfg.fc_dims} "
          f"embed={mcfg.embed_dim} seq={mcfg.seq_len} "
          f"shifts={qp['cfg_shifts']}")
    model = EngineModel(mcfg, serving.qparams_from_numpy(qp, "cuda"))

    # warm-up on a short prefix (cuBLAS, allocator), then the counted run
    warm = {k: v[:3 * batch] for k, v in stream.items()}
    replay(model, warm, "cuda", batch, cpe)
    fused_gate.launches = 0
    int8_gemm.launches = 0
    v_k, sys_k, sec_k = replay(model, stream, "cuda", batch, cpe)
    launches = {"fused_gate": fused_gate.launches,
                "int8_gemm": int8_gemm.launches}
    plain = dict(gate_backend="ref", matmul_backend="ref")
    v_r, sys_r, sec_r = replay(model, stream, "cuda", batch, cpe, **plain)
    require(fused_gate.launches == launches["fused_gate"]
            and int8_gemm.launches == launches["int8_gemm"],
            "the plain-backend replay launched a kernel")
    # timing in turns (kernels, plain, kernels, plain) on the same card
    sec_k2 = replay(model, stream, "cuda", batch, cpe)[2]
    sec_r2 = replay(model, stream, "cuda", batch, cpe, **plain)[2]
    chunks = -(-n // batch)
    stats = sys_k.stats
    print(f"replay (kernels): {n} packets in {sec_k:.4f} s, {sec_k2:.4f} s "
          f"= {n / sec_k:.1f}, {n / sec_k2:.1f} packets/s; inferences "
          f"{stats['inferences']}, granted {stats['granted']}, classified "
          f"{stats['classified_pkts']}, host_syncs {sys_k.host_syncs} (loop "
          "under sync debug mode 'error')")
    print(f"replay (plain backends on the card): {sec_r:.4f} s, "
          f"{sec_r2:.4f} s = {n / sec_r:.1f}, {n / sec_r2:.1f} packets/s")
    print(f"launches on the main path: fused_gate {launches['fused_gate']} "
          f"(chunks {chunks}), int8_gemm {launches['int8_gemm']} "
          f"(6 x chunks = {6 * chunks})")
    require(launches == {"fused_gate": chunks, "int8_gemm": 6 * chunks},
            f"launches {launches} for {chunks} chunks")
    require(sys_k.host_syncs == 0, "host syncs in the replay")
    require(np.array_equal(v_k, v_r), "kernel and plain verdicts differ")
    require(sys_k.stats == sys_r.stats,
            f"stats differ: {sys_k.stats} vs {sys_r.stats}")
    require(v_k.shape == (n,) and v_k.dtype == np.int32,
            f"verdicts {v_k.shape} {v_k.dtype}")
    require(v_k.min() >= -1 and v_k.max() < mcfg.num_classes,
            "verdict outside [-1, classes)")
    require(stats["inferences"] > 0 and stats["classified_pkts"] > 0,
            "the replay served no inference")
    print(f"verdict classes: {np.bincount(v_k + 1).tolist()} (index 0 = "
          "unclassified)")
    # the card against the port's CPU run on a prefix
    pre = {k: v[:4 * batch] for k, v in stream.items()}
    v_cpu, sys_cpu, _ = replay(model.to("cpu"), pre, "cpu", batch, cpe)
    model.to("cuda")
    v_gpu, sys_gpu, _ = replay(model, pre, "cuda", batch, cpe)
    require(np.array_equal(v_cpu, v_gpu) and sys_cpu.stats == sys_gpu.stats,
            "card and CPU differ on the prefix")
    print(f"prefix of {4 * batch} packets: card == CPU (verdicts, stats)")
    profile_replay(model, stream, batch, cpe, chunks)
    return launches, n / sec_k


def profile_replay(model, stream, batch, cpe, chunks):
    """One kernel replay under torch.profiler: device busy time and idle
    share (profiler overhead included), the top device kernels and the
    host ops by count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        sec = replay(model, stream, "cuda", batch, cpe)[2]
    avgs = prof.key_averages()

    def dev_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0))

    kern = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(a) for a in kern) / 1e6
    print(f"profile: replay {sec:.4f} s under the profiler, device busy "
          f"{busy:.4f} s, idle share {1 - busy / sec:.3f}")
    for a in kern[:8]:
        print(f"  device {dev_us(a) / 1e3:9.3f} ms  x{a.count:6d}  "
              f"{a.key[:90]}")
    host = sorted((a for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda a: a.count, reverse=True)
    n_ops = sum(a.count for a in host if a.key.startswith("aten::"))
    print(f"  host: {n_ops} aten ops = {n_ops / chunks:.0f} per chunk")
    for a in host[:10]:
        print(f"  host x{a.count:6d}  self cpu "
              f"{a.self_cpu_time_total / 1e3:9.3f} ms  {a.key[:60]}")


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase_environment()
    rng = np.random.default_rng(args.seed)
    gate = phase_gate(rng)
    gemm = phase_gemm(rng)
    launches, pps = phase_slice(args)
    kernels = [
        {"name": "fused_gate", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_gate.cu",
         "replaces": "src/repro/kernels/rate_gate/kernel.py:191",
         "launches": launches["fused_gate"], **gate},
        {"name": "int8_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/int8_gemm.cu",
         "replaces": "src/repro/kernels/int8_matmul/kernel.py:61",
         "launches": launches["int8_gemm"], **gemm},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
