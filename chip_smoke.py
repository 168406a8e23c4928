"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed S] [--packets N] [--model-dir DIR]
                          [--prompt-len S] [--new-tokens N]

Phases, in order; any failure exits non-zero and no phase catches one:

1. Environment: torch and CUDA versions, the card's name and power
   limit, and the build of every hand-written kernel from this
   checkout's sources (one nvcc per source, all at once, one library);
   the gates' 32-bit integer rate (64 a clock a SM x SMs x the max SM
   clock) and the instructions of one threefry draw, read from the
   built library's SASS, for the gates' bounds; int32 ``>>`` on the
   card against the CPU, by positive counts and by 0 and negative ones
   (which sign-fill: an RNN's ``lut_preshift`` may be either).
2. Kernels against their plain PyTorch versions on the card, each timed
   beside its plain version and its bound: the fused admission gate on
   given draws (``fused_gate``) and drawing its own threefry bits from a
   key (``fused_gate_prng``) at batch sizes from 1 to 2^22 (random LUTs,
   keys, bucket states, ragged batches, one cluster's batch and past it,
   lanes at a storage offset of 1, both batch-start register branches
   forced, and batches on which the bucket binds across CTAs and tiles),
   with the runtime calls of one ``fused_admission`` call (one kernel
   launch), the time at n = 1 (the floor of one launch) and GB/s at 2^20;
   the chunk step's threefry split and draws (``threefry_draw``, one
   launch for P pipes) against ``prng.split`` + ``prng.randint`` for P in
   {1, 4, 8}, up to 3 x 8192 + 5 lanes, spans 2^1, 2^16 and 2^31, keys
   with the words 0 and 2^32 - 1, timed at [1, 4096] and [4, 4096]
   beside the plain chain; the selection-only gate on given and on seeded
   draws (``rate_gate``, ``rate_gate_prng``); and the INT8 GEMM on a
   K-major B (as the serving weights are held) at the CNN path's six
   shapes and the RNN's three (M = 1024: [32, 128] with bias, [128, 128]
   without, the [128, 7] head; raw int32 out), each timed, plus ragged
   ones (K of the tiny models, M = 1), with and without bias, shift in
   {None, 0, 7}, beside ``torch._int_mm`` on a row-major and on a K-major
   B (the faster is the yardstick), with a sweep of every tile shape; a
   row-major B must be refused. The tolerance is exact equality (max |diff| = 0): every
   output is an integer.
3. The selection-only gate's path: a kernel sweep through the public op
   ``rate_gate`` over LUTs built for a range of flow counts and rates,
   on given draws and on seeded draws, each selection rate held to the
   LUT's expectation within 0.05 (the repo's own property check).
4. The slice: a ~2^18-packet synthetic ISCX trace replayed by
   ``FenixSystem``, serving the full-width INT8 FENIX-CNN (conv
   64/128/256, FC 512/256, embed 16, seq 9) with random int8 weights
   made from ``--seed`` (or a reference checkpoint from
   ``--model-dir``), on the device driver with each gate kernel
   (``gate_backend="cuda"`` and ``"cuda_prng"``, loop under
   ``torch.cuda.set_sync_debug_mode("error")``), each with the chunk
   step replayed as CUDA graphs (``step_backend="graph"``, the main
   path; captured once on a warm-up prefix, capture seconds printed) and
   run eagerly (``"eager"``), and with the plain backends; verdicts,
   stats and the final state, queue and delay-line tensors must be
   identical, and so must the kernel counts of graph and eager; packets/s
   of graph and eager in turns.  Graph against eager also on two
   run_trace calls in a row with ragged tails, on a slow Model Engine
   whose token bucket binds (a larger bucket must grant more), and with
   a switch decision tree (fit with ``fit_tree`` on the trace's windows;
   the host driver must agree, with packets answered by the tree).  The
   port's host driver (fast) on the card must give the device driver's
   verdicts and stats; the exact per-packet host driver over a prefix
   must give the same on the card and on the CPU, as must the device
   driver over a prefix.  Four more replays (each gate kernel, graph and
   eager) run under torch.profiler: the device's busy time and idle
   share (for graphs also by CUDA events around replays of the chunk
   graph), host launch calls (at most 4 a chunk on graphs) and copies
   per chunk, the top kernels.
4b. The full-width FENIX-RNN (embed 16, 128 units, seq 9, 7 classes)
   with seeded int8 weights, its shifts and tanh-LUT input shift picked
   on a calibration batch (printed, with h's shares at 0 and +-127), on
   phase 4's trace: graph == eager == plain backends for both gate
   kernels, 19 INT8 GEMMs a chunk, packets/s in turns, the card (graph)
   == the CPU (eager) on four chunks, and the four profiles.
4c. Oracle payloads (``oracle_windows=`` from the trace's flows) on the
   CNN and the RNN: graph == eager on the trace, graph == host driver
   (fast) == the CPU on a prefix with a ragged tail, and the rate beside
   the rate without them.
4d. Capture replay: the trace's flows written as a pcap
   (``synthesize_pcap``, 1000 packets more: two streamed blocks and a
   ragged tail), ingested back equal to the source stream, and streamed
   by ``run_trace`` (``TraceSpec`` with overlap on and off, a bare path)
   on the CNN system phase 4 captured: each == the in-memory replay,
   no capture, 0 host syncs, the chunks' kernel counts; the pcap's
   bytes and the parse-only, streaming and in-memory rates.
4e. Training: the Table-2 protocol of ``benchmarks/bench_accuracy.py``
   at full width, for both tasks (iscx, ustc) and both models (FENIX-CNN,
   FENIX-RNN), at the settings of the pinned reference values (250 flows,
   150 steps: ``benchmarks/run.py --fast``) and at bench_accuracy's own
   defaults (500 flows, 300 steps): ``make_flows``, the 75/25 flow
   split, ``train_quantized`` on the train step's CUDA graph (batch 256,
   lr 3e-3, warmup steps // 10, weight decay 0.01; 512 calibration
   windows), ``evaluate_quantized`` with the INT8 kernel (its predictions
   == the plain backend's); packet- and flow-level macro-F1 printed
   beside the pinned values with the confusion matrices, and at the
   pin's settings each flow-level macro-F1 held to its pinned value
   minus 0.05 (the reference's regression bar).  At the pin's settings
   the five baselines of ``bench_accuracy.run_task`` run beside them, in
   its order and with its settings: FlowLens (flow markers, the numpy
   GBDT), Leo and NetBeacon (fitted in numpy, predicting on the card),
   BoS and N3IC (trained with the port's ``Trainer`` on the train step's
   graph, batch 256, lr 3e-3, class weights); each macro-F1 printed
   beside its pinned value with the difference, held to the pinned value
   minus 0.05, with its seconds (and BoS's and N3IC's steps/s); then the
   full Table 2 (9 schemes x 2 tasks).  Then for the full-width
   CNN and RNN: the train step's graph == the eager step over 20 steps
   from one init (every step's metrics, params, moments, counter), a
   planted NaN batch that must leave them unchanged and count one
   recovery, the training rate of graph and eager in turns (steps/s,
   windows/s, launch calls, host syncs, device busy and idle share a
   step, capture seconds); and phase 4's trace replayed by the models
   trained on iscx, with the switch tree and oracle payloads (as
   ``examples/fenix_e2e.py``): graph == eager on both gate kernels ==
   plain backends, packets/s beside verdict coverage, per-packet accuracy
   and flow macro-F1.
4f. The multi-pipe driver (P=4, the Tofino's four ingress pipelines)
   and the engine farm (P=4 x E=4) on phase 4's trace and full-width
   CNN, batch 4096 a pipe: each gate kernel on graphs and eagerly, ==
   the plain backends (verdicts, stats, stacked state, queues, delay
   lines, engine queues); one gate launch a step whatever P (plus one a
   pipe's tail) and six GEMM launches (one flattened call a layer), 0
   host syncs; packets/s in turns, capture seconds, served_per_engine,
   the tails' share of the replay; one profile each (graph and eager) on
   the trace cut to whole batches a pipe (at most 4 launch calls a step
   on graphs); P=1 pipes == phase 4's device replay, E=1 farm == P=4
   pipes, and the card == the CPU on a prefix with ragged tails.  Phase
   2 holds the pipe-batched gates (P in 1-8, n up to 2^20, the bucket
   binding in one pipe only) to their plain versions and to one launch
   a pipe, and times them at [4, 4096] beside four one-pipe launches;
   the GEMM's step shapes (M x 4, M x 16) are timed beside _int_mm.
5. GQA decode attention (``decode_attention``) against its plain version
   in float32 and bfloat16, head dims 16-256, groups 1, 4, 5, 8 and (D
   128 and 256) 9, 12, 16, 32 (query heads in tiles of 8), ragged
   lengths with 1, S and an empty row (which must give 0), at the
   full-width Llama and qwen2-moe decode shapes, at recurrentgemma-9b's
   (B 8, one KV head, G 16, D 256, rings of 2048 keys, two of them full)
   and at its long_500k decode's (B 1, the ring full),
   at the four of the cross-attention families (B 8: seamless-m4t-medium's
   16 KV heads, G 1, D 64, self over the generate's cache with ragged
   lengths and cross over 2048 source frames, every row full;
   llama-3.2-vision-11b's 8 KV heads, G 4, D 128, self and cross over
   4096 image tokens) and at a long-context shape (B=32, S=32768);
   tolerances, element by
   element, 1e-5 in float32 (the reference's own) and one ulp of the
   plain output plus 1e-5 in bfloat16, which a planted fault (every row
   one tile short) must break.  Timed beside its plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never on the
   path), each against its bytes bound, with the split count the wrapper
   picks, the other split counts, GB/s and the share of the bound, and
   the clusters the card holds at once; recurrentgemma's shapes (B 8 and
   B 1), qwen2-moe-a2.7b's (B 8, 16 KV heads, G 1, D 128, mid-decode
   lengths) and the four cross-attention-family shapes each in turns
   beside SDPA.
6. LM serving: ``ServingEngine.generate`` on the full-width
   ``llama3.2-1b`` (16 layers, d_model 2048, 32/8 heads, vocab 128256)
   with random bfloat16 weights from ``--seed``, batch 8, a
   ``--prompt-len`` prompt and ``--new-tokens`` tokens, decode attention
   on the kernel and the decode loop under sync-debug "error", the
   decode step replayed as a CUDA graph (captured once per shape); the
   kernel's launches must equal layers x decode steps, and the eager
   step (``step_backend="eager"``) must give the same tokens and counts;
   ms a step and tok/s of both in turns.  The same inputs with
   ``attn_backend="ref"``, then the kernel's decode teacher-forced
   on the "ref" tokens: float32 logits (a float32 copy of the model) must
   agree within 1e-3 of their largest magnitude; bfloat16 differences and
   greedy agreement are printed.  Then the decode loop of the graph and
   of the eager engine under torch.profiler (ms a step, busy time, idle
   share, launch calls a step: at most 3 on the graph), an int8-weight
   generate, gated ``serve_requests`` through ``ServeGate`` (one graph
   for its one shape), and the reduced model on the card against the CPU.
6b. MoE serving: ``ServingEngine.generate`` on ``qwen2-moe-a2.7b`` at
   full width (d_model 2048, 16 heads, 60 experts top-4 + 4 gated shared
   experts, vocab 151936) cut in depth to ``MOE_LAYERS`` = 4 of its 24
   layers (the full depth's 14.31 B parameters took 94 s to draw), with
   random bfloat16 weights from ``--seed`` (init seconds printed),
   batch 8, the same prompt and new tokens: ``decode_attention``
   launches must equal the layers x decode steps, graph tokens == eager,
   the decode loop under sync-debug "error"; ms a step and tok/s of both
   in turns beside the step's bound (every weight and the K/V cache read
   once); a profile of the graph's decode loop; an int8-weight generate;
   peak memory; float32 logits, kernel against the einsum path, within
   1e-3 on a float32 copy of those 4 layers (at full depth it would not
   fit beside the bf16 model); the reduced model on the card against the
   CPU.
6c. The ssm family: ``generate`` on the full-width ``mamba2-370m`` (48
   layers, d_model 1024, SSM state 128, 32 heads; random bf16 weights
   from ``--seed``), batch 8, the same prompt and new tokens: no kernel
   of the port on its path (it has no attention), graph tokens and
   counts == eager, ms a step of both in turns beside the step's bound
   (every weight once, the float32 SSM states read and written), a
   profile of the graph's decode loop (at most 3 launch calls a step),
   an int8-weight generate, peak memory, the float32 decode recurrence
   against a float32 prefill of the same tokens within 1e-3, the
   reduced model on the card against the CPU; then ``long_500k``: batch
   1, a 524288-token prefill and 8 decode steps, its seconds and peak
   memory.
6d. The hybrid family: ``generate`` on the full-width
   ``recurrentgemma-9b`` (38 layers: 12 x (recurrent, recurrent,
   attention) + 2 recurrent; d_model 4096, 16 query heads over 1 KV
   head, D 256, a 2048-slot ring; 8.58 B parameters), batch 8, the same
   prompt and new tokens: 12 ``decode_attention`` launches a step (G 16
   on the kernel), graph == eager (and on a 2500-token prompt, whose
   prefill rolls the ring), the checks of 6c, the bf16 tokens of the
   einsum path's decode attention beside the kernel's (printed), and on
   a float32 copy cut to the first 2 superblocks (6 layers): greedy
   tokens of the kernel == the einsum path's, logits within 1e-3, and the
   decode against a prefill within 1e-3; on that cut, batch 1, a
   16384-token prefill in 4 segments of 4096 (``PREFILL_TOKENS`` forced)
   against one piece: last logits within 1e-3, greedy tokens equal.
   Then ``long_500k``: batch 1, a 524288-token prefill (in segments of
   ``recurrentgemma.PREFILL_TOKENS``) and 8 decode steps with 12
   ``decode_attention`` launches each, its seconds and peak memory.
6e. The encoder-decoder family: ``generate`` on the full-width
   ``seamless-m4t-medium`` (12 + 12 layers, d_model 1024, 16/16 heads, D
   64, vocab 256206; 0.98 B parameters), batch 8, the same prompt and
   new tokens, ``src_embeds`` [8, 2048, 1024] float32 normals from the
   seed (a source length other than the prompt's): 24 ``decode_attention``
   launches a step (12 self + 12 cross), graph tokens and counts == the
   eager step's, ms a step of both in turns beside the step's bound (the
   decoder's and head's weights and the self and cross K/V read once), a
   profile of the graph's decode loop, ``serve_requests`` with two
   source lengths (a cache and a graph each, tokens == fresh engines'),
   an int8 generate, peak memory, on a float32 copy at full depth the
   kernel's greedy tokens == the einsum path's and its logits within
   1e-3, and the reduced model on the card against the CPU.
6f. The vision LM: ``generate`` on the full-width
   ``llama-3.2-vision-11b`` (40 layers = 8 x (4 self + 1 gated cross),
   d_model 4096, 32 query heads over 8 KV heads, D 128, vocab 128256;
   9.77 B parameters) with every cross gate at 0.5 (at the reference's
   0 a cross layer is the identity and the image reaches no logit; the
   tokens at gates 0 must differ), ``image_embeds`` [8, 4096, 4096]
   float32 from the seed: 40 launches a step (32 self + 8 cross), the
   checks of 6e (but two source lengths), the float32 one on a copy cut
   to the first superblock (5 layers).
6g. MLA: ``generate`` on ``deepseek-v2-236b`` at full width (d_model
   5120, 128 heads, q-LoRA 1536, latent 512, rope 64, vocab 102400; 160
   experts top-6 + 2 shared, layer 0 dense with d_ff 12288), cut in depth
   to ``MLA_LAYERS`` = 2 layers (layer 0 dense + 1 MoE: its init is
   host-bound numpy draws; the full model's 236 B parameters, from
   ``init_params(abstract=True)``, printed beside ``analytic_param_count``:
   they do not fit one card), batch 8, the same prompt and new tokens:
   no kernel of the port on its path (the absorbed decode is plain torch
   ops; every count 0), graph tokens and counts == eager, ms a step of
   both in turns beside the step's bound (the routed experts an eager
   generate picks, the MLA, dense, shared and head weights, the latent
   cache; the dispatch's all-expert read volume printed beside it), a
   profile of the graph's decode loop, an int8 generate, peak memory; on
   a float32 copy cut to 2 layers (batch 1, a 1024-token prompt, a
   capacity factor at which no MoE pair drops) the absorbed decode's
   logits within 1e-3 of a decompressed prefill's of the same tokens,
   step by step, greedy tokens equal; the reduced model on the card
   against the CPU.
6h. LM training: the port's ``Trainer`` over ``api.loss_fn`` on the
   full-width ``llama3.2-1b`` (16 layers, d_model 2048, 32/8 heads, vocab
   128256, tied; bfloat16 params, float32 moments, remat "nothing") at
   train_4k's sequence of 4096, batch 2 (its global batch of 256 cut to
   what one card holds), batches from ``launch.train.token_batches`` and
   its OptConfig for 20 steps: the graph step (captured at its first
   step; the counts at 0 just before, none of the port's kernels on
   the path) == the eager step over 5 steps from one init (every step's
   metrics, params, moments, counter bit for bit); tokens/s and MFU
   (``api.model_flops`` / step / 989 TFLOP/s) of both in turns; the
   graph run to step 20, whose loss must be below step 1's; 8 graph
   steps profiled (launch calls and host syncs a step, busy, idle share,
   the top kernels); peak memory; the float32 head's backward
   (``_MatmulF32``) against the cast path's, timed; every family's
   reduced config (llama3.2-1b, qwen2-moe-a2.7b, deepseek-v2-236b,
   mamba2-370m, recurrentgemma-9b, seamless-m4t-medium and
   llama-3.2-vision-11b at gates 0.5) in float32, loss and gradients on
   the card against the CPU (1e-5, 1e-4); and the launcher
   (``repro_torch.launch.train.main``, in this process) on the card for
   6 steps with checkpoints every 3, rerun from its directory to step 10
   (it must resume from step 6).  About 80 s.
7. The dry run (``repro_torch.launch.dryrun``, traced on meta tensors
   along the card's path) and its roofline (``launch.roofline``, the
   H100's peaks): ``run_cell`` of llama3.2-1b at decode_32k's full shape
   (batch 128, 32768 keys) with its FLOPs, bytes, peak, ``fits_card``
   (false: its K/V cache alone is ~137 GB) and roofline terms beside the
   card's name and power limit.  Then two cells cut to fit, each traced
   on meta and run on the card with the cuda backends from the same
   ``build_step``: llama3.2-1b's decode step at batch 32 x 32768 (16
   ``decode_attention`` launches a step) and its train step at batch 1 x
   4096.  Each traced peak must lie within 10% of the card's
   ``max_memory_allocated`` rise over the step (after a warm-up step and
   ``reset_peak_memory_stats``, the inputs in place); the measured step
   time is printed beside the roofline's ``step_time_s``.  And
   ``card_latency_us`` of the full-width FENIX-CNN at 128 windows beside
   ``EngineModel.infer``'s time on 128 windows (6 ``int8_gemm``
   launches).  Then the reference's call forms on the card
   (``surface_checks``): ``from repro_torch import get_config``;
   ``ops.decode_attention(q, k, v, lengths, 256)`` (``ck`` in the
   reference's position) at llama3.2-1b's decode shape, bit for bit the
   call without ``ck`` (2 kernel launches, printed there and not in the
   ``kernels`` line); ``window_reset(state, cfg, now)``,
   ``window_reset_pipes`` and ``control_plane_update_pipes(state, cfg,
   P)`` on a stacked P=4 state on the card, equal to the same calls on a
   CPU copy; the checks' seconds printed.
8. Each phase's seconds and the total, the ``kernels`` JSON line
   (``int8_gemm``'s launches count the CNN's and the RNN's main paths,
   the trained models' replays, the pipes and farm paths and phase 7's
   infer; ``decode_attention``'s the llama, MoE, recurrentgemma
   (long_500k's included), seamless-m4t and llama-3.2-vision generates
   and phase 7's decode steps (deepseek-v2's and the training's add 0);
   the ``*_pipes`` rows are the pipe-batched gates of 4f),
   then the last line: ``{"ok": true, "device": {"platform": "gpu",
   ...}}``.

Launch counts are set to 0 just before each path is driven and read
just after.  It imports the port (``src/repro_torch``) and never JAX or
``repro``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import re
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
FP32_OPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12           # tensor-core bfloat16, dense
# The gates are 32-bit integer work (adds, shifts, logic, compares):
# compute capability 9.0 issues 64 such results a clock a SM (CUDA C++
# Programming Guide, arithmetic instruction throughput), so their rate
# is 64 x the SMs x the SM clock the card reports (phase 1 sets
# RATE["int32_ops_per_s"]).  One threefry2x32 draw costs the instructions
# counted in the built library's SASS (phase 1 sets RATE["threefry_ops"]).
INT32_OPS_PER_SM_CLOCK = 64
RATE = {}
SELECT_OPS_PER_LANE = 9           # shifts, clamps, LUT index, compare
GATE_OPS_PER_LANE = 12            # the selection, plus scan and credit
LUT_BYTES = 64 * 32 * 4
# llama3.2-1b's decode step reads its 2.47 GB of bf16 weights: 0.74 ms at
# 3.35 TB/s (PERF.md section 2)
WEIGHT_READ_MS = 0.74
KEY_BYTES = 2 * 8


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packets", type=int, default=1 << 18)
    ap.add_argument("--model-dir", default=None,
                    help="serve a reference save_quantized checkpoint "
                         "instead of seeded random weights")
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=32)
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

def threefry_sass_ops(lib):
    """Instructions of one threefry2x32 draw, read from the built
    library's SASS (``cuobjdump -sass``): the drawing selection kernel
    (``rate_gate_kernel<true>``) against the rand-input one
    (``<false>``).  A draw rotates 20 times, one funnel shift
    (``SHF.L.W``/``SHF.R.W``) or byte permute (``PRMT``, by 16 or 24)
    each, so the extra rotations over 20 count the draws
    the drawing kernel holds (the key's, and the lane's in each unrolled
    copy of the loop), and the extra instructions over that count are one
    draw's, with the lane work it replaces (the rand16 load) taken off."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    ops = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        for variant, tag in ((True, "rate_gate_kernelILb1E"),
                             (False, "rate_gate_kernelILb0E")):
            if tag in name:
                ops[variant] = [o for o in re.findall(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                    r"([A-Z][A-Z0-9_.]*)", block) if o != "NOP"]
    require(sorted(ops) == [False, True],
            f"rate_gate kernels not found in the SASS of {lib}")
    rot = {v: sum(o.startswith(("SHF.L.W", "SHF.R.W", "PRMT")) for o in x)
           for v, x in ops.items()}
    draws, rest = divmod(rot[True] - rot[False], 20)
    require(draws >= 1 and rest == 0,
            f"rotations in the SASS: {rot}, not whole draws")
    per = (len(ops[True]) - len(ops[False])) / draws
    print(f"threefry2x32 from the SASS: rate_gate_kernel<true> "
          f"{len(ops[True])} instructions, {rot[True]} rotations; <false> "
          f"{len(ops[False])}, {rot[False]}; {draws} draws, {per:.1f} "
          "instructions a draw")
    return per


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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].split(",")
    mhz_max, mhz_now = (float(c) for c in clocks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    RATE["int32_ops_per_s"] = INT32_OPS_PER_SM_CLOCK * sms * mhz_max * 1e6
    RATE["threefry_ops"] = threefry_sass_ops(_build.library_path())
    print(f"32-bit integer rate: {INT32_OPS_PER_SM_CLOCK} a clock a SM x "
          f"{sms} SMs x {mhz_max:.0f} MHz (max SM clock; now {mhz_now:.0f})"
          f" = {RATE['int32_ops_per_s'] / 1e12:.3f} T ops/s")
    x = torch.tensor([-5, -4, -1, 7, -2**31], dtype=torch.int32,
                     device="cuda")
    got = (x >> 1).cpu().tolist()
    require(got == [-3, -2, -1, 3, -2**30], f"int32 >> gave {got}")
    # counts of 0 and below (an RNN's lut_preshift may be either): a
    # negative count sign-fills (-1 for a negative value, 0 otherwise) on
    # the card as on the CPU and in XLA, by a Python int and by a tensor
    for count in (0, -1, -3):
        want = (x.cpu() >> count).tolist()
        for got in ((x >> count).cpu().tolist(),
                    (x >> torch.full_like(x, count)).cpu().tolist()):
            require(got == want, f"int32 >> {count} gave {got}, the CPU "
                    f"{want}")
    require((x >> -1).cpu().tolist() == [-1, -1, -1, 0, -1],
            "int32 >> -1 does not sign-fill")
    print("int32 >> on the card floors negative values, and by a count of "
          "0 or below matches the CPU (>> -1 sign-fills): ok")


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


def _bound_ms(byts, ops):
    """(bound in ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the 32-bit integer operations over their issue rate."""
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / RATE["int32_ops_per_s"]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _gate_bytes_ops(n, draw):
    """Fused gate: t_i, c_i, ts (and rand16 unless drawn) in, one byte a
    lane out; the LUT, the registers and the key once.  Returns (bytes,
    operations)."""
    lanes_in = 3 if draw else 4
    byts = n * (4 * lanes_in + 1) + LUT_BYTES + 2 * 4 + 4 \
        + (KEY_BYTES if draw else 0)
    ops = n * GATE_OPS_PER_LANE + (RATE["threefry_ops"] * (n + 1) if draw
                                   else 0)
    return byts, ops


def _gate_bound(n, draw):
    return _bound_ms(*_gate_bytes_ops(n, draw))


def _select_bound(n, draw):
    """Selection-only gate: t_i, c_i (and rand16 unless drawn) in, one
    byte a lane out; the LUT and the key once."""
    lanes_in = 2 if draw else 3
    byts = n * (4 * lanes_in + 1) + LUT_BYTES + (KEY_BYTES if draw else 0)
    ops = n * SELECT_OPS_PER_LANE + (RATE["threefry_ops"] * (n + 1)
                                     if draw else 0)
    return _bound_ms(byts, ops)


def _key(rng):
    """A random threefry key on the card: two uint32 words in int64."""
    return torch.from_numpy(rng.integers(0, 2**32, 2, dtype=np.int64)
                            ).cuda()


def _timed(name, n, kern, plain, bound, by, worst, launches):
    ms, plain_ms = device_ms(kern), device_ms(plain)
    print(f"{name} n={n}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms "
          f"(device time, graph replay); eager per call "
          f"{host_ms(kern):.5f} / {host_ms(plain):.5f} ms; bound "
          f"{bound:.7f} ms ({by}); no library call; launches so far "
          f"{launches()}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


# the fused gates' batch sizes: ragged ones, one CTA, one cluster (up to
# 8192 lanes) and past it (the look-back over 3, 7, 256 and 1024 tiles of
# 4096 lanes; 1024 tiles are about four waves of the card's 264 resident
# 1024-thread CTAs, so tiles wait on tiles of an earlier wave)
GATE_SIZES = (1, 256, 1000, 4059, 4096, 8192, 8193, 3 * 8192 + 5, 1 << 20,
              1 << 22)
GATE_TIMED = (1, 256, 4096, 8192, 1 << 20)
# batches on which the bucket binds (_binding_gate_case): in one cluster,
# just past it and across many tiles
BIND_SIZES = (4096, 8192, 8193, 3 * 8192 + 5, 1 << 20, 1 << 22)
BIND_COST, BIND_CAP = 3, 1 << 30


def _binding_gate_case(rng, n, dev):
    """A batch on which the token bucket binds all along, so that the
    spend carried across CTAs and tiles decides grants: a small starting
    bucket and timestamps that advance at the selected lanes' expected
    spend (BIND_COST a selected lane), running ahead of it and then
    behind it twice in the batch (runs of equal timestamps where they
    lag).  About half of the selected lanes are denied, in runs that
    cross CTAs and tiles; the cap is so high that the bucket level is
    never clipped, so it depends on every grant."""
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


def _misaligned(x):
    """A copy of ``x`` at a storage offset of one element (4 bytes past a
    16-byte boundary), contiguous."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x
    return buf[1:]


def _runtime_calls(fn):
    """(kernel launches, memsets) of one call of ``fn`` under
    torch.profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    return _launches(avgs)[0], sum(a.count for a in avgs
                                   if a.device_type == DeviceType.CPU
                                   and a.key.startswith("cudaMemset"))


GATE_LANES = ("t_i", "c_i", "ts", "rand16")


def gate_check(c, key, worst, cost, cap, lanes=None):
    """Both fused kernels through fused_admission on case ``c`` (its
    lanes, or the views ``lanes`` of them) against the plain versions,
    raising ``worst``'s max |diff| per kernel.  Returns {"fused_gate",
    "fused_gate_prng"}: (selected, granted, bucket') of the plain
    version."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.ops import fused_admission

    lanes = lanes or [c[k] for k in GATE_LANES]
    kw = dict(cost_us=cost, bucket_cap_us=cap)
    args = (*lanes[:3], c["lut"], c["bucket"], c["t_last"])
    prob = ref.lut_prob(c["lut"], c["t_i"], c["c_i"], 10, 0)
    out = {}
    for name, backend, draws in (
            ("fused_gate", "cuda", dict(rand16=lanes[3])),
            ("fused_gate_prng", "cuda_prng", dict(key=key))):
        plain = fused_admission(*args, backend="ref", **draws, **kw)
        got = fused_admission(*args, backend=backend, **draws, **kw)
        worst[name] = max(worst[name], max_abs_diff(plain[0], got[0]),
                          max_abs_diff(plain[1], got[1]))
        rand = lanes[3] if name == "fused_gate" \
            else ref.draw_rand16(key, prob.shape[0], 16)
        out[name] = (int((rand < prob).sum()), int(plain[0].sum()),
                     int(plain[1]))
    return out


def gate_correctness(rng):
    """Both fused kernels against their plain versions on random batches
    (GATE_SIZES), lanes at a storage offset of 1, the two branches of the
    batch-start registers forced, and batches on which the bucket binds
    (BIND_SIZES); returns the worst max |diff| per kernel."""
    cost, cap = 2, 128
    worst = {"fused_gate": 0, "fused_gate_prng": 0}
    for n in GATE_SIZES:
        for trial in range(8 if n <= 8192 else 3):
            c = _gate_case(rng, n, "cuda", cost, cap)
            res = gate_check(c, _key(rng), worst, cost, cap)
        print(f"fused gates n={n}: max|diff| {worst} "
              f"(selected, granted, bucket) {res}")
    for n in (1000, 4096, 3 * 8192 + 5):
        c = _gate_case(rng, n, "cuda", cost, cap)
        lanes = [_misaligned(c[k]) for k in GATE_LANES]
        require(all(x.data_ptr() % 16 == 4 for x in lanes),
                "misaligned views")
        res = gate_check(c, _key(rng), worst, cost, cap, lanes)
        print(f"fused gates n={n}, lanes at a storage offset of 1: "
              f"max|diff| {worst} (selected, granted, bucket) {res}")
    for n in (1000, 4096, 3 * 8192 + 5):
        for branch in ("t_last == 0", "bucket > cap"):
            c = _gate_case(rng, n, "cuda", cost, cap)
            if branch == "t_last == 0":
                c["t_last"].zero_()
            else:
                c["bucket"].fill_(cap + 1 + int(rng.integers(0, 3 * cap)))
            res = gate_check(c, _key(rng), worst, cost, cap)
        print(f"fused gates n={n}, {branch}: max|diff| {worst} "
              f"(selected, granted, bucket) {res}")
    for n in BIND_SIZES:
        c = _binding_gate_case(rng, n, "cuda")
        res = gate_check(c, _key(rng), worst, BIND_COST, BIND_CAP)
        print(f"fused gates n={n}, bucket binding: max|diff| {worst} "
              f"(selected, granted, bucket) {res}")
        for name, (sel, granted, bucket) in res.items():
            require(0.1 * sel < sel - granted < 0.9 * sel
                    and 0 < bucket < BIND_CAP,
                    f"{name} n={n}: the bucket does not bind ({sel} "
                    f"selected, {granted} granted, bucket {bucket})")
    return worst


def phase_gate(rng):
    """Both fused admission kernels against their plain versions; returns
    {"fused_gate": row, "fused_gate_prng": row} at n=4096."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.kernel import (fused_gate,
                                                      fused_gate_prng)
    from repro_torch.kernels.rate_gate.ops import fused_admission

    cost, cap = 2, 128
    kw = dict(cost_us=cost, bucket_cap_us=cap)
    worst = gate_correctness(rng)
    for name, w in worst.items():
        require(w == 0, f"{name} vs plain max|diff| {w}")

    # the wrapper launches its kernel and nothing else (and, above one
    # cluster's batch, a memset of the look-back's scratch)
    for n in (4096, 1 << 20):
        c = _gate_case(rng, n, "cuda", cost, cap)
        key = _key(rng)
        args = (c["t_i"], c["c_i"], c["ts"], c["lut"], c["bucket"],
                c["t_last"])
        calls = {
            "cuda": _runtime_calls(lambda: fused_admission(
                *args, rand16=c["rand16"], backend="cuda", **kw)),
            "cuda_prng": _runtime_calls(lambda: fused_admission(
                *args, key=key, backend="cuda_prng", **kw))}
        print(f"fused_admission n={n}: (kernel launches, memsets) a call "
              f"{calls}")
        require(all(launch == 1 for launch, _ in calls.values()),
                f"fused_admission launched {calls} at n={n}")

    out = {}
    for n in GATE_TIMED:
        c = _gate_case(rng, n, "cuda", cost, cap)
        key = _key(rng)
        t_ref = torch.where(c["t_last"] == 0, c["ts"][0], c["t_last"])
        burst0 = torch.clamp_max(c["bucket"], cap)
        regs = (c["bucket"], c["t_last"])
        kkw = dict(t_shift=10, c_shift=0, **kw)
        lanes = (c["t_i"], c["c_i"], c["ts"])
        rows = {
            "fused_gate": _timed(
                "fused_gate", n,
                lambda: fused_gate(*lanes, c["rand16"], c["lut"], *regs,
                                   **kkw),
                lambda: ref.fused_admission_ref(
                    *lanes, c["lut"], c["rand16"], burst0, t_ref, 10, 0,
                    cost, cap),
                *_gate_bound(n, False), worst["fused_gate"],
                lambda: fused_gate.launches),
            "fused_gate_prng": _timed(
                "fused_gate_prng", n,
                lambda: fused_gate_prng(*lanes, key, c["lut"], *regs,
                                        prob_bits=16, **kkw),
                lambda: ref.fused_admission_prng_ref(
                    *lanes, c["lut"], key, burst0, t_ref, 10, 0, cost, cap,
                    16),
                *_gate_bound(n, True), worst["fused_gate_prng"],
                lambda: fused_gate_prng.launches)}
        if n >= 1 << 20:
            for name, row in rows.items():
                byts, ops = _gate_bytes_ops(n, name.endswith("prng"))
                print(f"{name} n={n}: {byts / 1e6:.3f} MB at "
                      f"{byts / row['ms'] / 1e6:.1f} GB/s, {ops / 1e6:.2f} "
                      f"M integer ops; {row['bound_ms'] / row['ms']:.3f} of "
                      f"the {row['bound_ms']:.5f} ms bound "
                      f"({row['bound_by']})")
        out[n] = rows
    return out[4096]


# the pipe-batched gates: P pipes' batches in one launch (the multi-pipe
# driver's step), each pipe its own LUT, registers and key
PIPE_GATE_PIPES = (1, 2, 4, 8)
PIPE_GATE_SIZES = (1, 1000, 1024, 4096, 8192, 3 * 8192 + 5, 1 << 20)
PIPE_BIND_SIZES = (4096, 8192, 3 * 8192 + 5, 1 << 20)


def _pipe_gate_case(rng, pipes, n, dev, cost, cap, bind=None):
    """P pipes' cases stacked: lanes [P, n], LUT [P, 64, 32], registers
    [P], keys [P, 2], each pipe drawn on its own.  With ``bind`` = q, pipe
    q's batch is a binding one (_binding_gate_case, BIND_COST/BIND_CAP)
    and every other pipe's bucket is full, so only pipe q binds."""
    cases = []
    for q in range(pipes):
        if bind is None:
            c = _gate_case(rng, n, dev, cost, cap)
        elif q == bind:
            c = _binding_gate_case(rng, n, dev)
        else:
            c = _gate_case(rng, n, dev, BIND_COST, BIND_CAP)
            c["bucket"].fill_(BIND_CAP)
        c["key"] = _key(rng)
        cases.append(c)
    return {k: torch.stack([c[k] for c in cases]).contiguous()
            for k in cases[0]}


def pipe_gate_check(c, worst, cost, cap):
    """Both fused kernels on the stacked case ``c`` in one launch each,
    against the plain versions over [P, n] and against one launch a pipe
    of the same kernel; raises ``worst``'s max |diff| per kernel.  Returns
    {kernel: (selected [P], granted [P])} of the plain version."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.kernel import (fused_gate,
                                                      fused_gate_prng)
    from repro_torch.kernels.rate_gate.ops import fused_admission

    kw = dict(cost_us=cost, bucket_cap_us=cap)
    lanes = (c["t_i"], c["c_i"], c["ts"])
    args = (*lanes, c["lut"], c["bucket"], c["t_last"])
    prob = ref.lut_prob(c["lut"], c["t_i"], c["c_i"], 10, 0)
    out = {}
    for name, backend, draws, kern in (
            ("fused_gate", "cuda", dict(rand16=c["rand16"]), fused_gate),
            ("fused_gate_prng", "cuda_prng", dict(key=c["key"]),
             fused_gate_prng)):
        plain = fused_admission(*args, backend="ref", **draws, **kw)
        before = kern.launches
        got = fused_admission(*args, backend=backend, **draws, **kw)
        require(kern.launches == before + 1,
                f"{name}: {kern.launches - before} launches for "
                f"{c['t_i'].shape[0]} pipes")
        one = [fused_admission(*(x[q] for x in args), backend=backend,
                               **{k: v[q] for k, v in draws.items()}, **kw)
               for q in range(c["t_i"].shape[0])]
        worst[name] = max(
            worst[name], max_abs_diff(plain[0], got[0]),
            max_abs_diff(plain[1], got[1]),
            max_abs_diff(torch.stack([o[0] for o in one]), got[0]),
            max_abs_diff(torch.stack([o[1] for o in one]), got[1]))
        rand = c["rand16"] if name == "fused_gate" \
            else ref.draw_rand16(c["key"], prob.shape[-1], 16)
        out[name] = ((rand < prob).sum(-1).tolist(),
                     plain[0].sum(-1).tolist())
    return out


def _pipe_gate_bound(pipes, n, draw):
    byts, ops = _gate_bytes_ops(n, draw)
    return _bound_ms(pipes * byts, pipes * ops)


def phase_pipe_gate(rng):
    """The fused gates over a leading pipe dimension (one launch for P
    pipes' batches) against their plain versions and one launch a pipe,
    P in PIPE_GATE_PIPES at PIPE_GATE_SIZES and on batches where the
    bucket binds in one pipe only; then timed at the pipes driver's shape
    [4, 4096] beside four one-pipe launches and the bytes bound.  Returns
    the kernels-line rows of the pipe-batched form."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.kernel import (fused_gate,
                                                      fused_gate_prng)

    cost, cap = 2, 128
    worst = {"fused_gate": 0, "fused_gate_prng": 0}
    for pipes in PIPE_GATE_PIPES:
        for n in PIPE_GATE_SIZES:
            if pipes * n > 1 << 22:
                continue
            c = _pipe_gate_case(rng, pipes, n, "cuda", cost, cap)
            res = pipe_gate_check(c, worst, cost, cap)
        print(f"pipe-batched fused gates P={pipes}, n up to "
              f"{PIPE_GATE_SIZES[-1]}: max|diff| {worst} (plain == one "
              "launch for all pipes == one launch a pipe)")
    for pipes in (2, 4, 8):
        for n in PIPE_BIND_SIZES:
            bind = int(rng.integers(0, pipes))
            c = _pipe_gate_case(rng, pipes, n, "cuda", BIND_COST, BIND_CAP,
                                bind=bind)
            res = pipe_gate_check(c, worst, BIND_COST, BIND_CAP)
            for name, (sel, granted) in res.items():
                denied = [s_ - g for s_, g in zip(sel, granted)]
                require(0.1 * sel[bind] < denied[bind] < 0.9 * sel[bind]
                        and sum(denied) == denied[bind],
                        f"{name} P={pipes} n={n}: the bucket binds in pipe "
                        f"{bind} only? denied {denied} of {sel}")
        print(f"pipe-batched fused gates P={pipes}, bucket binding in one "
              f"pipe: max|diff| {worst} (denied {denied})")
    for name, w in worst.items():
        require(w == 0, f"pipe-batched {name} vs plain max|diff| {w}")

    pipes, n = 4, 4096
    c = _pipe_gate_case(rng, pipes, n, "cuda", cost, cap)
    t_ref = torch.where(c["t_last"] == 0, c["ts"][:, 0], c["t_last"])
    burst0 = torch.clamp_max(c["bucket"], cap)
    regs = (c["bucket"], c["t_last"])
    lanes = (c["t_i"], c["c_i"], c["ts"])
    kkw = dict(t_shift=10, c_shift=0, cost_us=cost, bucket_cap_us=cap)
    rows = {}
    for name, kern, draws, plain, draw in (
            ("fused_gate", fused_gate, c["rand16"],
             lambda: ref.fused_admission_ref(*lanes, c["lut"], c["rand16"],
                                             burst0, t_ref, 10, 0, cost,
                                             cap), False),
            ("fused_gate_prng", fused_gate_prng, c["key"],
             lambda: ref.fused_admission_prng_ref(*lanes, c["lut"],
                                                  c["key"], burst0, t_ref,
                                                  10, 0, cost, cap, 16),
             True)):
        xkw = dict(kkw, prob_bits=16) if draw else kkw
        split = [tuple(x[q] for x in (*lanes, draws, c["lut"], *regs))
                 for q in range(pipes)]

        def batched(kern=kern, draws=draws, xkw=xkw):
            return kern(*lanes, draws, c["lut"], *regs, **xkw)

        def one_a_pipe(kern=kern, split=split, xkw=xkw):
            return [kern(*a, **xkw) for a in split]

        bound, by = _pipe_gate_bound(pipes, n, draw)
        ms, ms4, plain_ms = (device_ms(batched), device_ms(one_a_pipe),
                             device_ms(plain))
        print(f"{name} [{pipes}, {n}]: one launch {ms:.5f} ms, {pipes} "
              f"one-pipe launches {ms4:.5f} ms ({ms4 / ms:.2f}x), plain "
              f"{plain_ms:.5f} ms (device time, graph replay); bound "
              f"{bound:.7f} ms ({by}); launches so far {kern.launches}")
        rows[name + "_pipes"] = {
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    return rows


# the chunk step's threefry draws: pipes, lanes (0: the split alone) and
# spans; the edge keys hold the words 0 and 2^32 - 1 and the cells' own
THREEFRY_PIPES = (1, 4, 8)
THREEFRY_SIZES = (0, 1, 1000, 4096, 3 * 8192 + 5)
THREEFRY_BITS = (1, 16, 31)
THREEFRY_EDGE_KEYS = ((0, 0), (0, 1), (0, 2), (0, 3), (0, 2**32 - 1),
                      (2**32 - 1, 0), (2**32 - 1, 2**32 - 1))


def _threefry_bound(pipes, n):
    """(bound in ms, what bounds it) of one threefry_draw launch: P x (n
    + 3) threefry2x32 calls (the lanes', the split's two, the draw
    key's) at the 32-bit rate; P x (16 + 32) key bytes and 4 a lane."""
    return _bound_ms(pipes * (48 + 4 * n),
                     RATE["threefry_ops"] * pipes * (n + 3))


def phase_threefry(rng):
    """The chunk step's threefry split and draws (``threefry_draw``, one
    launch for every pipe) against the plain prng.split + prng.randint
    on the card, then timed at the cells' [1, 4096] and the pipes
    driver's [4, 4096] beside the plain chain (graphed and eager), its
    bound and the split alone ([P, 0], the floor of one launch).
    Returns the kernels-line row at [1, 4096]."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.kernel import threefry_draw

    worst = 0
    for pipes in THREEFRY_PIPES:
        for n in THREEFRY_SIZES:
            for bits in THREEFRY_BITS:
                keys = np.array(THREEFRY_EDGE_KEYS + tuple(map(tuple, (
                    rng.integers(0, 2**32, (pipes, 2))))), np.int64)
                for lo in range(0, len(keys) - pipes + 1, pipes):
                    key = torch.from_numpy(keys[lo:lo + pipes]).cuda()
                    got = threefry_draw(key, n, bits)
                    want = ref.threefry_draw_ref(key, n, bits)
                    worst = max([worst] + [max_abs_diff(a, b) for a, b in
                                           zip(want, got)])
        print(f"threefry_draw P={pipes}, n in {THREEFRY_SIZES}, prob_bits "
              f"in {THREEFRY_BITS}: max|diff| {worst} (key', sub, rand16)")
    require(worst == 0, f"threefry_draw vs plain max|diff| {worst}")

    rows = {}
    for pipes in (1, 4):
        key = torch.from_numpy(rng.integers(0, 2**32, (pipes, 2),
                                            dtype=np.int64)).cuda()
        n = 4096
        bound, by = _threefry_bound(pipes, n)
        rows[pipes] = _timed(
            f"threefry_draw [{pipes}, {n}]", n,
            lambda: threefry_draw(key, n, 16),
            lambda: ref.threefry_draw_ref(key, n, 16), bound, by, worst,
            lambda: threefry_draw.launches)
        split_ms = device_ms(lambda: threefry_draw(key, 0, 16))
        print(f"threefry_draw [{pipes}, 0] (the split alone, one launch): "
              f"{split_ms:.5f} ms; [{pipes}, {n}] at "
              f"{bound / rows[pipes]['ms']:.5f} of its bound")
    return {"threefry_draw": rows[1]}


def phase_select(rng):
    """Both selection-only kernels against their plain versions; returns
    {"rate_gate": row, "rate_gate_prng": row} at n=4096."""
    from repro_torch.kernels.rate_gate import ref
    from repro_torch.kernels.rate_gate.kernel import rate_gate as kernel
    from repro_torch.kernels.rate_gate.kernel import rate_gate_prng
    from repro_torch.kernels.rate_gate.ops import rate_gate

    worst = {"rate_gate": 0, "rate_gate_prng": 0}
    for n in (1, 255, 1000, 4096, 8192, 1 << 20):
        for trial in range(4):
            c = _gate_case(rng, n, "cuda", 2, 128)
            seed = int(rng.integers(0, 2**31))
            lanes = (c["t_i"], c["c_i"], c["lut"])
            worst["rate_gate"] = max(worst["rate_gate"], max_abs_diff(
                rate_gate(*lanes, rand16=c["rand16"], backend="ref"),
                rate_gate(*lanes, rand16=c["rand16"], backend="cuda")))
            worst["rate_gate_prng"] = max(worst["rate_gate_prng"],
                                          max_abs_diff(
                rate_gate(*lanes, seed=seed, backend="ref"),
                rate_gate(*lanes, seed=seed, backend="cuda_prng")))
        print(f"selection gates n={n}: max|diff| {worst}")
    for name, w in worst.items():
        require(w == 0, f"{name} vs plain max|diff| {w}")
    out = {}
    for n in (4096, 1 << 20):
        c = _gate_case(rng, n, "cuda", 2, 128)
        key = _key(rng)
        lanes = (c["t_i"], c["c_i"])
        out[n] = {
            "rate_gate": _timed(
                "rate_gate", n,
                lambda: kernel(*lanes, c["rand16"], c["lut"], t_shift=10,
                               c_shift=0),
                lambda: ref.rate_gate_ref(*lanes, c["lut"], c["rand16"], 10,
                                          0),
                *_select_bound(n, False), worst["rate_gate"],
                lambda: kernel.launches),
            "rate_gate_prng": _timed(
                "rate_gate_prng", n,
                lambda: rate_gate_prng(*lanes, key, c["lut"], t_shift=10,
                                       c_shift=0, prob_bits=16),
                lambda: ref.rate_gate_prng_ref(*lanes, c["lut"], key, 10, 0,
                                               16),
                *_select_bound(n, True), worst["rate_gate_prng"],
                lambda: rate_gate_prng.launches)}
    for name, row in out[1 << 20].items():
        print(f"{name} n={1 << 20}: {row['ms']:.5f} ms, "
              f"{row['bound_ms'] / row['ms']:.3f} of the "
              f"{row['bound_ms']:.5f} ms bound ({row['bound_by']})")
    return out[4096]


# the six GEMMs of one chunk of the full-width CNN: 1024 served lanes x 9
# (name, M, K, N, shift, bias)
PATH_GEMMS = (("conv0", 9216, 96, 64, 7, True),
              ("conv1", 9216, 192, 128, 7, True),
              ("conv2", 9216, 384, 256, 7, True),
              ("fc0", 1024, 256, 512, 7, True),
              ("fc1", 1024, 512, 256, 7, True),
              ("head", 1024, 256, 7, None, True))
# the full-width FENIX-RNN's three GEMM shapes at 1024 served lanes: each
# of the 9 steps runs the input GEMM (bias, raw int32) and the recurrent
# one (no bias, raw int32), then the head runs once: 19 a chunk
RNN_GEMMS = (("cell/wx", 1024, 32, 128, None, True),
             ("cell/wh", 1024, 128, 128, None, False),
             ("rnn head", 1024, 128, 7, None, True))
RNN_GEMM_REPEATS = {"cell/wx": 9, "cell/wh": 9, "rnn head": 1}


def _gemm_bound_ms(m, k, n, shift, bias=True):
    byts = m * k + k * n + (4 * n if bias else 0) \
        + m * n * (1 if shift is not None else 4)
    t_bytes = byts / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_gemm(rng):
    from repro_torch.kernels.int8_matmul.kernel import (TILES, gemm_tile,
                                                        int8_gemm)
    from repro_torch.kernels.int8_matmul.ops import int8_matmul, k_major
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def operands(m, k, n):
        """a [m, k], b [k, n] K-major (as the serving weights are held),
        bias [n], on the card."""
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        bias = torch.from_numpy(rng.integers(-50_000, 50_000, n,
                                             dtype=np.int32))
        return a.cuda(), k_major(b.cuda()), bias.cuda()

    worst = 0
    # the paths' shapes (CNN and RNN), then ragged M/N/K: K of the tiny
    # models (24, 8, 16), odd K, M = 1
    shapes = [s[1:4] for s in PATH_GEMMS + RNN_GEMMS] + [
        (1, 1, 1), (17, 33, 9), (1000, 100, 70), (4099, 200, 130),
        (1, 256, 7), (1, 96, 64), (2304, 24, 16), (300, 8, 7),
        (1024, 16, 7), (77, 512, 300)]
    for m, k, n in shapes:
        a, b, bias = operands(m, k, n)
        for shift in (None, 0, 7):
            for bb in (None, bias):
                ref = int8_matmul(a, b, bb, shift, backend="ref")
                got = int8_matmul(a, b, bb, shift, backend="cuda")
                worst = max(worst, max_abs_diff(got, ref))
        neg = int((int8_matmul(a, b, None, None, backend="cuda") < 0)
                  .sum())
        print(f"int8_gemm [{m},{k}]x[{k},{n}] (tile "
              f"{TILES[gemm_tile(m, n, sms)]}): max|diff|={worst} "
              f"negative accumulators={neg}")
    require(worst == 0, f"int8_gemm vs plain max|diff| {worst}")
    a, b, _ = operands(64, 32, 16)
    try:
        int8_gemm(a, b.contiguous())
    except ValueError as e:
        print(f"int8_gemm refuses a row-major b: {e}")
    else:
        require(False, "int8_gemm took a row-major b")
    def timed(name, m, k, n, shift, with_bias):
        """One path GEMM timed beside its plain version, torch._int_mm on
        both B layouts and its bound; returns the numbers by key."""
        a, b, bias = operands(m, k, n)
        bias = bias if with_bias else None
        # torch._int_mm (the raw int32 product only) needs N % 8 == 0:
        # the head's 7 columns are padded to 8 for the yardstick, which
        # is timed on a row-major and on a K-major B, the faster kept
        b_row = b.contiguous()
        if n % 8:
            b_row = torch.nn.functional.pad(b_row, (0, 8 - n % 8))
        b_col = k_major(b_row)

        def kern():
            return int8_gemm(a, b, bias, shift)

        def plain():
            return int8_matmul_ref(a, b, bias, shift)

        diff = max_abs_diff(kern(), plain())
        require(diff == 0, f"int8_gemm {name}: max|diff| {diff}")
        lib_ms = {}
        for layout, bl in (("row-major", b_row), ("K-major", b_col)):
            try:
                torch._int_mm(a, bl)
            except RuntimeError as e:
                print(f"torch._int_mm refuses a {layout} B: "
                      f"{str(e).splitlines()[0]}")
                continue
            lib_ms[layout] = device_ms(lambda bl=bl: torch._int_mm(a, bl))
        require(bool(lib_ms), "torch._int_mm took neither layout")
        ms, plain_ms = device_ms(kern), device_ms(plain)
        bound, bb = _gemm_bound_ms(m, k, n, shift, with_bias)
        lib = min(lib_ms.values())
        libs = ", ".join(f"{lay} {t:.5f} ms" for lay, t in lib_ms.items())
        print(f"int8_gemm {name} [{m},{k}]x[{k},{n}] "
              f"{'bias' if with_bias else 'no bias'}, shift {shift}, tile "
              f"{TILES[gemm_tile(m, n, sms)]}: max|diff|={diff}; kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, torch._int_mm {libs} "
              f"(device time, graph replay); eager kernel call "
              f"{host_ms(kern):.5f} ms; bound {bound:.6f} ms ({bb}, "
              f"{bound / ms:.3f} of it); kernel / _int_mm {ms / lib:.3f}")
        sweep = ", ".join(
            f"{bm}x{bn} "
            f"{device_ms(lambda i=i: int8_gemm(a, b, bias, shift, i)):.5f}"
            for i, (bm, bn) in enumerate(TILES))
        print(f"  tile sweep ({name}, ms): {sweep}")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "library_ms": lib, "bound_by": bb}

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    by = set()
    for name, m, k, n, shift, with_bias in PATH_GEMMS:
        row = timed(name, m, k, n, shift, with_bias)
        by.add(row["bound_by"])
        for key in total:
            total[key] += row[key]
    rnn = dict.fromkeys(total, 0.0)
    for name, m, k, n, shift, with_bias in RNN_GEMMS:
        row = timed(name, m, k, n, shift, with_bias)
        for key in rnn:
            rnn[key] += RNN_GEMM_REPEATS[name] * row[key]
    print(f"int8_gemm per RNN chunk (9 x cell/wx + 9 x cell/wh + head = 19 "
          f"GEMMs): kernel {rnn['ms']:.5f} ms, plain {rnn['plain_ms']:.5f} "
          f"ms, torch._int_mm {rnn['library_ms']:.5f} ms (the faster layout "
          f"of each), bound {rnn['bound_ms']:.6f} ms "
          f"({rnn['bound_ms'] / rnn['ms']:.3f} of it); kernel / _int_mm "
          f"{rnn['ms'] / rnn['library_ms']:.3f}")
    print(f"int8_gemm per CNN chunk (six GEMMs): kernel {total['ms']:.5f} ms, "
          f"plain {total['plain_ms']:.5f} ms, torch._int_mm "
          f"{total['library_ms']:.5f} ms (the faster layout of each), "
          f"bound {total['bound_ms']:.6f} ms "
          f"({total['bound_ms'] / total['ms']:.3f} of it); launches so far "
          f"{int8_gemm.launches}")
    # the pipes and farm steps serve every pipe's (engine's) lanes in one
    # flattened GEMM a layer: M times P (P x E)
    for scale, what in ((PIPES, f"pipes step (P={PIPES})"),
                        (PIPES * ENGINES,
                         f"farm step (P={PIPES} x E={ENGINES})")):
        step = dict.fromkeys(total, 0.0)
        for name, m, k, n, shift, with_bias in PATH_GEMMS:
            row = timed(f"{name} x{scale}", m * scale, k, n, shift,
                        with_bias)
            for key in step:
                step[key] += row[key]
        print(f"int8_gemm per {what} (six GEMMs, M x {scale}): kernel "
              f"{step['ms']:.5f} ms, plain {step['plain_ms']:.5f} ms, "
              f"torch._int_mm {step['library_ms']:.5f} ms, bound "
              f"{step['bound_ms']:.6f} ms "
              f"({step['bound_ms'] / step['ms']:.3f} of it); kernel / "
              f"_int_mm {step['ms'] / step['library_ms']:.3f}")
    return {"max_abs_err": worst, **total,
            "bound_by": "bytes" if by == {"bytes"} else "operations"}


# -- phase 3 ----------------------------------------------------------------

def phase_select_sweep(rng):
    """The selection-only gate's path: a sweep through the public op
    ``rate_gate`` (default backend on the card, and ``"cuda_prng"`` on
    seeded draws) over LUTs for a range of flow counts and rates, each
    selection rate within 0.05 of the LUT's expectation.  Returns the
    launches of the two kernels in the sweep."""
    from repro_torch.core.probability import LUTConfig, build_lut
    from repro_torch.kernels.rate_gate.kernel import rate_gate as kernel
    from repro_torch.kernels.rate_gate.kernel import rate_gate_prng
    from repro_torch.kernels.rate_gate.ops import rate_gate

    lcfg, n = LUTConfig(), 4096
    cases = [(int(f), float(v), int(s)) for f, v, s in zip(
        rng.integers(10, 2000, 12), rng.uniform(0.01, 0.2, 12),
        rng.integers(0, 2**31, 12))]
    kernel.launches = rate_gate_prng.launches = 0
    worst = 0.0
    for n_flows, v, seed in cases:
        lut_np = build_lut(n=float(n_flows), q=1.0, v=v, cfg=lcfg)
        t = rng.integers(0, 1 << 16, n).astype(np.int32)
        c = rng.integers(0, 32, n).astype(np.int32)
        ti = np.clip(t >> lcfg.t_shift, 0, lcfg.t_bins - 1)
        ci = np.clip(c >> lcfg.c_shift, 0, lcfg.c_bins - 1)
        expect = lut_np[ti, ci].sum() / float(1 << 16) / n
        lut, t, c = (torch.from_numpy(a).cuda() for a in (lut_np, t, c))
        r16 = torch.from_numpy(rng.integers(0, 1 << 16, n).astype(
            np.int32)).cuda()
        for sel in (rate_gate(t, c, lut, rand16=r16),
                    rate_gate(t, c, lut, seed=seed, backend="cuda_prng")):
            worst = max(worst, abs(float(sel.float().mean()) - expect))
    launches = {"rate_gate": kernel.launches,
                "rate_gate_prng": rate_gate_prng.launches}
    print(f"rate_gate sweep: {len(cases)} LUTs x {n} lanes, worst |rate - "
          f"expected| {worst:.4f} (limit 0.05); launches {launches}")
    require(worst < 0.05, f"selection rate off by {worst}")
    require(launches == {"rate_gate": len(cases),
                         "rate_gate_prng": len(cases)},
            f"sweep launches {launches}")
    return launches


# -- phase 4 ----------------------------------------------------------------

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


def make_system(model, device, batch, cpe, tree=None, sys_kw=None,
                **cfg_kw):
    from repro_torch.core.fenix import FenixConfig, FenixSystem

    return FenixSystem(FenixConfig(model="int8_cnn", batch_size=batch,
                                   control_plane_every=cpe, **cfg_kw),
                       model, tree=tree, device=device, **(sys_kw or {}))


def run(sys_, stream, reset=True):
    """One run_trace on a kept system (from a fresh state unless
    ``reset`` is false); returns (verdicts, seconds)."""
    if reset:
        sys_.reset()
    if sys_.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sys_.run_trace(stream)            # returns host arrays: synced
    return out["verdict"], time.perf_counter() - t0


def replay(model, stream, device, batch, cpe, tree=None, **cfg_kw):
    """A run on a new system: (verdicts, system, seconds)."""
    sys_ = make_system(model, device, batch, cpe, tree=tree, **cfg_kw)
    v, sec = run(sys_, stream)
    return v, sys_, sec


def _counts():
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.int8_matmul.kernel import int8_gemm
    from repro_torch.kernels.rate_gate.kernel import (fused_gate,
                                                      fused_gate_prng,
                                                      threefry_draw)

    return {"fused_gate": fused_gate, "fused_gate_prng": fused_gate_prng,
            "threefry_draw": threefry_draw, "int8_gemm": int8_gemm,
            "decode_attention": decode_attention}


def zero_counts():
    for k in _counts().values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, k in _counts().items()}


def counted_run(sys_, stream):
    """A run with every kernel count set to 0 just before it; returns
    (verdicts, seconds, launches in this run)."""
    zero_counts()
    v, sec = run(sys_, stream)
    return v, sec, read_counts()


def same_run(a, b, what):
    """Identical verdicts and stats of two (verdicts, system) runs."""
    require(np.array_equal(a[0], b[0]), f"{what}: verdicts differ")
    require(a[1].stats == b[1].stats,
            f"{what}: stats differ: {a[1].stats} vs {b[1].stats}")


def same_carry(a, b, what):
    """Identical final state, queue and delay-line tensors."""
    for name in ("state", "queues", "_dl"):
        x, y = getattr(a, name), getattr(b, name)
        require(sorted(x) == sorted(y), f"{what}: {name} keys differ")
        for k in x:
            require(torch.equal(x[k].cpu(), y[k].cpu()),
                    f"{what}: {name}[{k!r}] differs")


def graph_vs_eager(g, e, stream, what, parts=None):
    """The same trace (or its ``parts``, replayed one after another on one
    system) on the graph and the eager system: verdicts, stats and final
    tensors identical, no host sync."""
    parts = parts or [stream]
    runs = []
    for sys_ in (e, g):
        sys_.reset()
        runs.append(np.concatenate([run(sys_, p, reset=False)[0]
                                    for p in parts]))
        require(sys_.host_syncs == 0, f"{what}: host syncs")
    same_run((runs[0], e), (runs[1], g), f"{what}: graph vs eager")
    same_carry(e, g, f"{what}: graph vs eager")
    return runs[1]


def gemms_per_chunk(mcfg):
    """INT8 GEMM launches of one served chunk: each conv and FC layer and
    the head (CNN); the two cell GEMMs of each step and the head (RNN)."""
    if mcfg.kind == "rnn":
        return 2 * mcfg.seq_len + 1
    return len(mcfg.conv_filters) + len(mcfg.fc_dims) + 1


def drive_model(model, mcfg, stream, batch, cpe):
    """The main path of one served model: the trace replayed on the
    device driver with each gate kernel, as CUDA graphs (captured on a
    warm-up prefix) and eagerly, each kernel count at 0 before each
    replay; graph == eager (verdicts, stats, final tensors, counts) ==
    the plain backends on the card; packets/s of graph and eager in
    turns.  Returns the systems, the runs and the main path's counts."""
    n = len(stream["ts_us"])
    chunks = -(-n // batch)
    per = gemms_per_chunk(mcfg)
    gates = ("cuda", "cuda_prng")
    systems = {(gate, step): make_system(model, "cuda", batch, cpe,
                                         gate_backend=gate,
                                         step_backend=step)
               for gate in gates for step in ("graph", "eager")}
    plain = make_system(model, "cuda", batch, cpe, gate_backend="ref",
                        matmul_backend="ref")

    # warm-up on a prefix of one window and a chunk (cuBLAS, allocator,
    # and the graph systems capture both chunk graphs: the steady state)
    warm = {k: v[:(cpe + 1) * batch] for k, v in stream.items()}
    for sys_ in (*systems.values(), plain):
        run(sys_, warm)
    for gate in gates:
        g = systems[(gate, "graph")]
        require(sorted(g._graphs) == [False, True], "graphs not captured")
        print(f"capture (gate {gate}): both chunk graphs in "
              f"{g.capture_s:.4f} s (warm-up on copies of the carry + "
              "capture), outside every timed replay; the address check "
              f"before a replay takes {stale_check_ms(g._graphs[False]):.5f}"
              f" ms of host time ({len(g._graphs[False]._held)} tensors)")

    # the main path: the graph replays, each kernel count at 0 before it
    want = {"cuda": {"fused_gate": chunks, "fused_gate_prng": 0,
                     "threefry_draw": chunks, "int8_gemm": per * chunks,
                     "decode_attention": 0},
            "cuda_prng": {"fused_gate": 0, "fused_gate_prng": chunks,
                          "threefry_draw": chunks, "int8_gemm": per * chunks,
                          "decode_attention": 0}}
    res, counted = {}, {}
    for gate in gates:
        for step in ("graph", "eager"):
            sys_ = systems[(gate, step)]
            v, sec, counted[(gate, step)] = counted_run(sys_, stream)
            require(counted[(gate, step)] == want[gate],
                    f"launches {counted[(gate, step)]} for {chunks} chunks "
                    f"(gate {gate!r}, {step}); want {want[gate]}")
            require(sys_.host_syncs == 0 and sys_.capture_s == 0.0,
                    f"gate {gate} {step}: host syncs or a new capture")
            res[(gate, step)] = (v, sys_, sec)
        same_run(res[(gate, "graph")], res[(gate, "eager")],
                 f"gate {gate}: graph vs eager")
        same_carry(res[(gate, "graph")][1], res[(gate, "eager")][1],
                   f"gate {gate}: graph vs eager")
    # the kernels line: the counts of the graph replays (the main path)
    launches = {"fused_gate": counted[("cuda", "graph")]["fused_gate"],
                "fused_gate_prng":
                    counted[("cuda_prng", "graph")]["fused_gate_prng"],
                "threefry_draw": counted[("cuda", "graph")]["threefry_draw"],
                "int8_gemm": counted[("cuda", "graph")]["int8_gemm"]}
    v_r, _, launches_r = counted_run(plain, stream)
    require(not any(launches_r.values()),
            f"the plain-backend replay launched kernels: {launches_r}")
    v_k, sys_k, sec_k = res[("cuda", "graph")]
    v_p, sys_p, _ = res[("cuda_prng", "graph")]
    same_run((v_k, sys_k), (v_r, plain), "gate cuda vs plain")
    same_run((v_p, sys_p), (v_k, sys_k), "gate cuda_prng vs cuda")
    print("graph replay == eager replay (verdicts, stats, state, queues, "
          "delay line) for gate cuda and cuda_prng; == plain backends; "
          "0 host syncs")

    # timing in turns on the same card: eager, graph, graph, eager
    rate = {}
    for gate in gates:
        for step in ("eager", "graph", "graph", "eager"):
            sec = run(systems[(gate, step)], stream)[1]
            rate.setdefault((gate, step), []).append(n / sec)
        print(f"replay (gate {gate}): graph "
              f"{', '.join(f'{r:.1f}' for r in rate[(gate, 'graph')])} "
              f"packets/s; eager "
              f"{', '.join(f'{r:.1f}' for r in rate[(gate, 'eager')])} "
              "packets/s (in turns: eager, graph, graph, eager)")
    sec_r = run(plain, stream)[1]
    stats = sys_k.stats
    print(f"replay (plain backends on the card, graph): {n / sec_r:.1f} "
          f"packets/s; inferences {stats['inferences']}, granted "
          f"{stats['granted']}, classified {stats['classified_pkts']}")
    print(f"launches on the main path: {launches} (chunks {chunks}, "
          f"{per} x chunks = {per * chunks}), the same under graph and "
          "eager")
    require(v_k.shape == (n,) and v_k.dtype == np.int32,
            f"verdicts {v_k.shape} {v_k.dtype}")
    require(v_k.min() >= -1 and v_k.max() < mcfg.num_classes,
            "verdict outside [-1, classes)")
    require(stats["inferences"] > 0 and stats["classified_pkts"] > 0,
            "the replay served no inference")
    print(f"verdict classes: {np.bincount(v_k + 1).tolist()} (index 0 = "
          "unclassified)")

    return {"systems": systems, "plain": plain, "res": res,
            "launches": launches, "rate": rate}


def phase_slice(args):
    from repro_torch.configs.fenix_models import fenix_cnn
    from repro_torch.core.data_engine.decision_tree import (fit_tree,
                                                            tree_arrays)
    from repro_torch.core.data_engine.state import EngineConfig
    from repro_torch.core.model_engine import serving
    from repro_torch.core.model_engine.inference import EngineModel
    from repro_torch.data.synthetic_traffic import (make_flows,
                                                    packet_stream,
                                                    windows_from_flows)

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
    chunks = -(-n // batch)
    base = (model, stream, "cuda", batch, cpe)
    gates = ("cuda", "cuda_prng")
    d = drive_model(model, mcfg, stream, batch, cpe)
    systems, launches, rate = d["systems"], d["launches"], d["rate"]
    v_k, sys_k, sec_k = d["res"][("cuda", "graph")]
    # the device replay phase 4f holds the pipes driver at P=1 to
    device_run = (v_k, copy.deepcopy(sys_k.stats),
                  {k: v.clone() for k, v in sys_k.state.items()})

    # two run_trace calls in a row on new systems (the graph system
    # captures in the first), each with a ragged tail
    cut = (0, 100_003, n - 1000)
    parts = [{k: v[lo:hi] for k, v in stream.items()}
             for lo, hi in zip(cut, cut[1:])]
    two = {step: make_system(model, "cuda", batch, cpe, step_backend=step)
           for step in ("graph", "eager")}
    graph_vs_eager(two["graph"], two["eager"], stream,
                   "two calls with ragged tails", parts)
    print(f"two run_trace calls in a row ({cut[1]} + {cut[2] - cut[1]} "
          "packets, both ragged): graph == eager")
    del two

    # a slow Model Engine on which the token bucket binds: a bucket 2^14
    # times larger grants more on the same trace and LUT
    slow = dict(engine=EngineConfig(fpga_hz=5e3))
    bind_kw = dict(n_est=50, q_est_pps=2e4)
    bind = {step: make_system(model, "cuda", batch, cpe, sys_kw=bind_kw,
                              step_backend=step, **slow)
            for step in ("graph", "eager")}
    graph_vs_eager(bind["graph"], bind["eager"], stream, "binding bucket")
    wide = make_system(model, "cuda", batch, cpe, sys_kw=bind_kw,
                       engine=EngineConfig(fpga_hz=5e3, queue_len=1 << 20))
    run(wide, stream)
    g_bind, g_wide = (bind["graph"].stats["granted"],
                      wide.stats["granted"])
    require(0 < g_bind < g_wide,
            f"the bucket did not bind: granted {g_bind} vs {g_wide}")
    print(f"binding bucket (fpga_hz 5e3, cost "
          f"{slow['engine'].cost_us} us): graph == eager; granted {g_bind} "
          f"against {g_wide} with a 2^14 x larger bucket")

    # the host driver (fast) on the card: the device driver's oracle
    v_h, sys_h, sec_h = replay(*base, driver="host")
    same_run((v_h, sys_h), (v_k, sys_k), "host driver vs device driver")
    require(sys_h.host_syncs == chunks // cpe,
            f"host driver control-plane calls {sys_h.host_syncs}")
    print(f"host driver (fast) on the card: {sec_h:.4f} s = "
          f"{n / sec_h:.1f} packets/s, {sys_h.host_syncs} control-plane "
          "round trips; verdicts and stats == device driver")

    # the switch decision tree, fit on the trace's windows
    x, y, _ = windows_from_flows(flows)
    tree = tree_arrays(fit_tree(x[:, -1, :], y, depth=4,
                                num_classes=mcfg.num_classes), "cuda")
    tree_sys = {step: make_system(model, "cuda", batch, cpe, tree=tree,
                                  step_backend=step)
                for step in ("graph", "eager")}
    v_td = graph_vs_eager(tree_sys["graph"], tree_sys["eager"], stream,
                          "tree")
    sys_td = tree_sys["graph"]
    v_th, sys_th, sec_th = replay(*base, tree=tree, driver="host")
    same_run((v_th, sys_th), (v_td, sys_td), "tree: host vs device")
    require(sys_td.stats["tree_pkts"] > 0, "the tree answered no packet")
    print(f"tree replay: device graph == eager == host ({sec_th:.4f} s); "
          f"tree_pkts {sys_td.stats['tree_pkts']}, classified "
          f"{sys_td.stats['classified_pkts']}/{n}")

    # the card against the port's CPU runs on prefixes: the exact
    # per-packet host driver, and the device driver (graph on the card)
    ex_n, ex_b, ex_cpe = 3072, 256, 2
    ex = {k: v[:ex_n] for k, v in stream.items()}
    pre = {k: v[:4 * batch] for k, v in stream.items()}
    v_eg, sys_eg, sec_eg = replay(model, ex, "cuda", ex_b, ex_cpe,
                                  driver="host", exact=True)
    v_gpu, sys_gpu, _ = replay(model, pre, "cuda", batch, cpe)
    model_cpu = copy.deepcopy(model).to("cpu")   # the card's model stays
    v_ec, sys_ec, sec_ec = replay(model_cpu, ex, "cpu", ex_b, ex_cpe,
                                  driver="host", exact=True)
    v_cpu, sys_cpu, _ = replay(model_cpu, pre, "cpu", batch, cpe)
    same_run((v_eg, sys_eg), (v_ec, sys_ec), "exact prefix: card vs CPU")
    for k in ("hash", "cls", "ring", "bucket", "lut", "rng_key",
              "denied_prob", "denied_tokens", "collisions"):
        require(torch.equal(sys_eg.state[k].cpu(), sys_ec.state[k]),
                f"exact prefix: state {k} differs")
    require(sys_eg.stats["inferences"] > 0, "the exact prefix served none")
    print(f"exact host driver, prefix of {ex_n} packets (batch {ex_b}): "
          f"card {sec_eg:.4f} s ({ex_n / sec_eg:.1f} packets/s), CPU "
          f"{sec_ec:.4f} s; card == CPU (verdicts, stats, tables)")
    same_run((v_gpu, sys_gpu), (v_cpu, sys_cpu), "prefix: card vs CPU")
    same_carry(sys_gpu, sys_cpu, "prefix: card (graph) vs CPU (eager)")
    print(f"prefix of {4 * batch} packets: card (graph) == CPU (eager): "
          "verdicts, stats, final tensors")
    # a graph system whose model moves after capture (a round trip
    # through the host) captures again and still gives the same answer
    moved = copy.deepcopy(model)
    sys_mv = make_system(moved, "cuda", batch, cpe)
    v_mv0 = run(sys_mv, pre)[0]
    moved.to("cpu")
    moved.to("cuda")
    require(all(g.stale() for g in sys_mv._graphs.values()),
            "moved weights left a chunk graph current")
    v_mv1 = run(sys_mv, pre)[0]
    require(sys_mv.capture_s > 0, "moved weights: no new capture")
    same_run((v_mv1, sys_mv), (v_gpu, sys_gpu), "moved weights")
    require(np.array_equal(v_mv0, v_mv1), "moved weights: verdicts moved")
    print(f"model moved to the host and back after capture: the chunk "
          f"graphs recaptured ({sys_mv.capture_s:.4f} s), verdicts and "
          "stats unchanged")
    del sys_mv, moved
    for gate in gates:
        for step in ("graph", "eager"):
            profile_replay(systems[(gate, step)], stream, chunks,
                           f"gate {gate}, {step}")
    ctx = {"flows": flows, "stream": stream, "model": model,
           "systems": systems, "batch": batch, "cpe": cpe,
           "rate": {k: max(v) for k, v in rate.items()},
           "device_run": device_run}
    return launches, ctx


def _launches(avgs):
    """Host launch calls in a profile: cudaLaunchKernel, the cluster
    launches (cudaLaunchKernelExC) and CUDA-graph launches
    (cudaGraphLaunch); returns (launch calls, memcpy calls)."""
    from torch.autograd import DeviceType

    host = [a for a in avgs if a.device_type == DeviceType.CPU]
    calls = sum(a.count for a in host
                if a.key in ("cudaLaunchKernel", "cudaGraphLaunch")
                or a.key.startswith("cudaLaunchKernelEx"))
    copies = sum(a.count for a in host if a.key.startswith("cudaMemcpy"))
    return calls, copies


def _port_kernels(avgs):
    """The port's own kernels among a profile's device entries."""
    names = ("fused_gate", "rate_gate", "int8_gemm", "decode_attention")
    return [a for a in avgs if any(n in a.key for n in names)]


def counts_match_profile(kern, what):
    """The profiler's count of each of the port's kernels over a run
    equals the wrappers' counters over the same run (set to 0 just
    before it): a graph that lost or doubled a kernel node fails here.
    The two gate kernels are summed (a system runs one of them)."""
    c = read_counts()
    want = {"fused_gate": c["fused_gate"] + c["fused_gate_prng"],
            "int8_gemm": c["int8_gemm"],
            "decode_attention": c["decode_attention"]}
    seen = {name: sum(a.count for a in kern if name in a.key)
            for name in want}
    require(seen == want, f"{what}: the profile holds kernels {seen}; the "
            f"counters say {want}")
    return seen


STEP_SPAN = "chip_smoke decode step"


def step_units(prof, graph):
    """The steps of a decode profile, as a map from each launch call's
    correlation id (its kernels' too) to its step: a graph step is one
    ``cudaGraphLaunch``; an eager step, the launch calls in its
    ``STEP_SPAN`` span."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    if graph:
        ids = [e.id for e in cpu if e.name.startswith("cudaGraphLaunch")]
        return {i: n for n, i in enumerate(ids)}
    spans = sorted((e.time_range.start, e.time_range.end) for e in cpu
                   if e.name == STEP_SPAN)
    units = {}
    for e in cpu:
        if e.name.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset")):
            t = e.time_range.start
            units.update({e.id: n for n, (t0, t1) in enumerate(spans)
                          if t0 <= t <= t1})
    return units


def steps_match_counts(prof, units, steps, what):
    """The port's kernels in each step of a decode profile equal the
    launches the step makes: the wrappers' counters over the run (set to
    0 just before it) over ``steps``.  ``units`` maps each launch's
    correlation id to its step (:func:`step_units`).  The profiler now
    and then loses a run of a step's kernel records (on the H100: the
    first few kernels of the first graph replay after tracing starts, a
    few layers of one replay of the 40-layer vision step, one attention
    kernel of an eager llama3.2-1b step); every step launches the same
    kernels, so a step that holds fewer records than the fullest lost
    them and is set aside, its loss printed, while a graph that lost or
    doubled a kernel node, or a wrapper that counts what it did not
    launch, differs in every step.  At least half the steps must be
    full.  Returns (the port's kernels a step, full steps, records
    lost)."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    c = read_counts()
    total = {"fused_gate": c["fused_gate"] + c["fused_gate_prng"],
             "int8_gemm": c["int8_gemm"],
             "decode_attention": c["decode_attention"]}
    require(all(n % steps == 0 for n in total.values()),
            f"{what}: the counters {total} are not whole steps")
    want = {name: n // steps for name, n in total.items()}
    require(len(set(units.values())) == steps, f"{what}: launches of "
            f"{len(set(units.values()))} steps in the profile for {steps}")
    groups = defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.id in units:
            groups[units[e.id]].append(e.name)
    size = [len(groups[n]) for n in range(steps)]
    full = max(size)
    kept = [n for n in range(steps) if size[n] == full]
    require(2 * len(kept) >= steps, f"{what}: only {len(kept)} of {steps} "
            f"steps hold all {full} records ({size})")
    for n in kept:
        seen = {name: sum(name in k for k in groups[n]) for name in want}
        require(seen == want, f"{what}: step {n} holds the port's kernels "
                f"{seen}; the counters say {want} a step")
    return want, len(kept), sum(full - k for k in size)


def graph_chunks_match_counts(prof, chunks, what):
    """The port's kernels in each chunk graph's replay of a graph
    system's profile equal the launches a chunk makes: the wrappers'
    counters over the run (set to 0 just before it) over ``chunks``.  As
    in :func:`steps_match_counts`, the profiler now and then loses the
    kernel records of a replay (on the H100: the first chunk's, one gate
    and six GEMMs, after tracing starts); a chunk holding fewer of the
    port's kernels is set aside, its loss printed, while a graph that
    lost or doubled a kernel node, or a wrapper that counts what it did
    not launch, differs in every chunk.  At least half the chunks must
    be full, and none may hold more.  Returns the port's kernels the
    profile holds."""
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType

    c = read_counts()
    total = {"fused_gate": c["fused_gate"] + c["fused_gate_prng"],
             "int8_gemm": c["int8_gemm"],
             "decode_attention": c["decode_attention"]}
    require(all(n % chunks == 0 for n in total.values()),
            f"{what}: the counters {total} are not whole chunks")
    want = {name: n // chunks for name, n in total.items()}
    units = step_units(prof, True)
    require(len(units) == chunks, f"{what}: {len(units)} graph replays in "
            f"the profile for {chunks} chunks")
    groups = defaultdict(Counter)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.id in units:
            for name in want:
                groups[units[e.id]][name] += name in e.name
    short = []
    for n in range(chunks):
        seen = {name: groups[n][name] for name in want}
        require(all(seen[k] <= want[k] for k in want), f"{what}: chunk {n} "
                f"holds the port's kernels {seen}, more than the counters' "
                f"{want} a chunk")
        short += [n] if seen != want else []
    require(2 * len(short) <= chunks, f"{what}: only {chunks - len(short)} "
            f"of {chunks} chunks hold the counters' {want} a chunk")
    if short:
        print(f"  {what}: the profiler lost kernel records of chunks "
              f"{short}; the other {chunks - len(short)} hold the "
              f"counters' {want} a chunk")
    return {name: sum(g[name] for g in groups.values()) for name in want}


def _dev_us(a):
    return getattr(a, "self_device_time_total",
                   getattr(a, "self_cuda_time_total", 0))


def stale_check_ms(graph, iters=1000):
    """Host milliseconds of the address check a replay makes first (the
    tensors the step reads outside its buffers, against capture)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        graph.stale()
    return (time.perf_counter() - t0) / iters * 1e3


def graph_device_s(graph, reps):
    """Device seconds of one replay of a captured graph: ``reps`` replays
    back to back between two CUDA events (the graph's kernels and the
    gaps between them on the device; no host gap)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def profile_replay(sys_, stream, chunks, what):
    """One replay under torch.profiler (the system's reset before it, not
    in it): device busy time and idle share (against the profiled replay,
    profiler overhead included, and against the same replay timed just
    before without the profiler), host launch calls and copies per chunk,
    the top device kernels and the host ops by count.  On a graph system
    the busy time is also read with CUDA events around back-to-back
    replays of its chunk graph, as a cross-check; the profile must hold
    as many of the port's kernels as the counters count (a graph
    system's chunk by chunk: :func:`graph_chunks_match_counts`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sec_plain = run(sys_, stream)[1]
    zero_counts()
    sys_.reset()              # outside the profile: it is not the replay's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        sec = run(sys_, stream, reset=False)[1]
    avgs = prof.key_averages()
    kern = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                  key=_dev_us, reverse=True)
    if sys_.step_backend == "graph":
        seen = graph_chunks_match_counts(prof, chunks, f"profile ({what})")
    else:
        seen = counts_match_profile(kern, f"profile ({what})")
    busy = sum(_dev_us(a) for a in kern) / 1e6
    host = sorted((a for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda a: a.count, reverse=True)
    n_launch, n_copy = _launches(avgs)
    n_ops = sum(a.count for a in host if a.key.startswith("aten::"))
    note = ""
    if sys_.step_backend == "graph":
        g = sys_._graphs[False]
        ev = chunks * graph_device_s(g.graph, 20)
        sys_.reset()          # the extra replays moved the carry buffers
        note = f" (CUDA events around the chunk graph: {ev:.4f} s)"
    print(f"profile ({what}): replay {sec:.4f} s under the profiler, "
          f"device busy {busy:.4f} s{note}, idle share "
          f"{1 - busy / sec:.3f} (against {sec_plain:.4f} s without the "
          f"profiler: {1 - busy / sec_plain:.3f}); {n_launch} launch calls = "
          f"{n_launch / chunks:.2f} per chunk (cudaLaunchKernel + "
          f"cudaLaunchKernelEx* + cudaGraphLaunch), {n_copy} memcpy calls "
          f"= {n_copy / chunks:.2f} per chunk; {n_ops} aten ops = "
          f"{n_ops / chunks:.1f} per chunk; port kernels in the profile "
          f"{seen}, held to the counters")
    for a in kern[:8] + _port_kernels(kern[8:]):
        print(f"  device {_dev_us(a) / 1e3:9.3f} ms  x{a.count:6d}  "
              f"{a.key[:90]}")
    for a in host[:10]:
        print(f"  host x{a.count:6d}  self cpu "
              f"{a.self_cpu_time_total / 1e3:9.3f} ms  {a.key[:60]}")
    if sys_.step_backend == "graph":
        require(n_launch / chunks <= 4, f"{what}: {n_launch} launch calls "
                f"for {chunks} chunks")


# -- phase 4b ---------------------------------------------------------------

def seeded_rnn_qparams(mcfg, seed, calib):
    """Random int8 weights in ``quantize_traffic``'s RNN layout, with the
    cell's shifts chosen on a calibration batch: each cell GEMM's 99th
    percentile of |accumulator| lands near 512 after its shift
    (``shift_x``, ``shift_h``), and ``lut_preshift`` puts the 99th
    percentile of |pre| near index 32 of the tanh LUT (whose step is
    1/16: tanh(2)), so h neither vanishes nor sits at +-127.  The LUT
    holds tanh on a 2^-7 grid.  The head's bias centres the classes'
    logits on the same batch.  Returns the qparams and the shares of
    h's entries at 0 and at +-127 on the batch."""
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.models.traffic import bucketize

    rng = np.random.default_rng(seed + 1)
    e, u, steps = mcfg.embed_dim, mcfg.rnn_units, mcfg.seq_len

    def w8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def q99(t):
        return float(np.percentile(np.abs(t.numpy()), 99))

    def shift_for(t, target):
        return max(0, round(math.log2(max(q99(t), 1.0) / target)))

    qp = {"embed_len/table": w8(mcfg.len_buckets, e),
          "embed_ipd/table": w8(mcfg.ipd_buckets, e),
          "cell/wx": w8(2 * e, u), "cell/wh": w8(u, u)}
    ids = bucketize(torch.from_numpy(calib), mcfg).long().transpose(0, 1)
    x = torch.cat([torch.from_numpy(qp["embed_len/table"])[ids[..., 0]],
                   torch.from_numpy(qp["embed_ipd/table"])[ids[..., 1]]],
                  dim=-1)                                  # [T, M, 2E]
    wx, wh = (torch.from_numpy(qp[k]) for k in ("cell/wx", "cell/wh"))
    accx = torch.stack([int8_matmul(x[t], wx, None, None, backend="ref")
                        for t in range(steps)])
    scale = int(np.median(np.abs(accx.numpy()))) + 1
    qp["cell/b"] = rng.integers(-scale, scale + 1, u).astype(np.int32)
    accx = accx + torch.from_numpy(qp["cell/b"])
    sx = shift_for(accx, 512)
    idx = np.arange(-256, 256)
    qp["tanh_lut"] = np.clip(np.round(np.tanh(idx / 16) * 128), -127,
                             127).astype(np.int8)
    lut = torch.from_numpy(qp["tanh_lut"])

    def recur(sh, lp):
        h = torch.zeros((x.shape[1], u), dtype=torch.int8)
        acch_all, pre_all = [], []
        for t in range(steps):
            acch = int8_matmul(h, wh, None, None, backend="ref")
            pre = (accx[t] >> sx) + (acch >> sh)
            h = lut[(torch.clamp(pre >> lp, -256, 255) + 256).long()]
            acch_all.append(acch)
            pre_all.append(pre)
        return h, torch.stack(acch_all), torch.stack(pre_all)

    sh, lp = 0, shift_for(accx >> sx, 32)
    for _ in range(3):              # the shifts and h settle together
        _, acch, pre = recur(sh, lp)
        sh, lp = shift_for(acch, 512), shift_for(pre, 32)
    h, _, _ = recur(sh, lp)
    hv = h.to(torch.int32).abs()
    shares = (float((hv == 0).float().mean()),
              float((hv == 127).float().mean()))
    qp.update({"cell/shift_x": sx, "cell/shift_h": sh,
               "cell/lut_preshift": lp})
    head = w8(u, mcfg.num_classes)
    acc = int8_matmul(h, torch.from_numpy(head), None, None, backend="ref")
    qp["head/w"] = head
    qp["head/b"] = (-acc.to(torch.float64).mean(dim=0)).round().numpy() \
        .astype(np.int32)
    qp["head/shift"] = 0
    qp["cfg_shifts"] = {"shift_x": sx, "shift_h": sh, "lut_preshift": lp}
    return qp, shares


def phase_rnn(args, ctx):
    """4b. The full-width FENIX-RNN on phase 4's trace: the main path of
    ``drive_model`` (19 INT8 GEMMs a chunk), the card (graph) against the
    CPU (eager) on a prefix of four chunks, and the replays under the
    profiler.  Returns (the main path's int8_gemm launches, the model,
    its graph system under gate "cuda")."""
    from repro_torch.configs.fenix_models import fenix_rnn
    from repro_torch.core.model_engine import serving
    from repro_torch.core.model_engine.inference import EngineModel

    flows, stream = ctx["flows"], ctx["stream"]
    batch, cpe = ctx["batch"], ctx["cpe"]
    n = len(stream["ts_us"])
    chunks = -(-n // batch)
    mcfg = fenix_rnn()
    qp, (zero, sat) = seeded_rnn_qparams(mcfg, args.seed,
                                         _calib_windows(flows, 1024, 9))
    print(f"model: {mcfg.name} embed={mcfg.embed_dim} "
          f"units={mcfg.rnn_units} seq={mcfg.seq_len} "
          f"classes={mcfg.num_classes} shifts={qp['cfg_shifts']}; on the "
          f"calibration batch h is 0 in {zero:.3f} and +-127 in {sat:.3f} "
          "of its entries")
    require(zero < 0.5 and sat < 0.5, f"h at 0 in {zero}, at +-127 in "
            f"{sat} of its entries")
    model = EngineModel(mcfg, serving.qparams_from_numpy(qp, "cuda"))
    d = drive_model(model, mcfg, stream, batch, cpe)
    v_k, sys_k, _ = d["res"][("cuda", "graph")]
    require(len(np.unique(v_k[v_k >= 0])) > 1,
            "the RNN replay gave one class only")
    pre = {k: v[:4 * batch] for k, v in stream.items()}
    v_gpu, sys_gpu, _ = replay(model, pre, "cuda", batch, cpe)
    model_cpu = copy.deepcopy(model).to("cpu")
    v_cpu, sys_cpu, _ = replay(model_cpu, pre, "cpu", batch, cpe)
    same_run((v_gpu, sys_gpu), (v_cpu, sys_cpu), "RNN prefix: card vs CPU")
    same_carry(sys_gpu, sys_cpu, "RNN prefix: card (graph) vs CPU (eager)")
    print(f"RNN prefix of {4 * batch} packets: card (graph) == CPU (eager):"
          " verdicts, stats, final tensors")
    for gate in ("cuda", "cuda_prng"):
        for step in ("graph", "eager"):
            profile_replay(d["systems"][(gate, step)], stream, chunks,
                           f"RNN, gate {gate}, {step}")
    return (d["launches"]["int8_gemm"], model,
            d["systems"][("cuda", "graph")])


# -- phase 4c ---------------------------------------------------------------

def phase_oracle(ctx, rnn_model, rnn_sys):
    """4c. Oracle payloads (``oracle_windows=`` from the trace's flows)
    on the CNN and the RNN: graph == eager on the whole trace (the same
    kernel counts as without them), the card's graph == its host driver
    (fast) == the CPU (eager) on a prefix with a ragged tail, and the
    replay rate beside the rate without an oracle, in turns."""
    flows, stream = ctx["flows"], ctx["stream"]
    batch, cpe = ctx["batch"], ctx["cpe"]
    n = len(stream["ts_us"])
    chunks = -(-n // batch)
    oracle = [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
              for f in flows]
    kw = dict(sys_kw=dict(oracle_windows=oracle))
    pre = {k: v[:4 * batch + 1000] for k, v in stream.items()}
    warm = {k: v[:(cpe + 1) * batch] for k, v in stream.items()}
    for name, model, plain_sys in (
            ("CNN", ctx["model"], ctx["systems"][("cuda", "graph")]),
            ("RNN", rnn_model, rnn_sys)):
        per = gemms_per_chunk(model.cfg)
        g = make_system(model, "cuda", batch, cpe, **kw)
        e = make_system(model, "cuda", batch, cpe, step_backend="eager",
                        **kw)
        run(g, warm)                                       # capture
        for sys_ in (g, e):
            _, _, counts = counted_run(sys_, stream)
            require(counts["fused_gate"] == chunks
                    and counts["int8_gemm"] == per * chunks,
                    f"{name} oracle: launches {counts}")
            require(sys_.capture_s == 0.0, f"{name} oracle: a new capture")
        v_g = graph_vs_eager(g, e, stream, f"{name} oracle")
        v_plain = run(plain_sys, stream)[0]
        print(f"{name} oracle payloads, {n} packets: graph == eager "
              f"(verdicts, stats, final tensors; launches {counts}); "
              f"{int((v_g != v_plain).sum())} verdicts differ from the "
              "replay without them")
        v_gp, _ = run(g, pre)
        v_h, sys_h, _ = replay(model, pre, "cuda", batch, cpe,
                               driver="host", **kw)
        same_run((v_gp, g), (v_h, sys_h), f"{name} oracle: graph vs host")
        v_c, sys_c, _ = replay(copy.deepcopy(model).to("cpu"), pre, "cpu",
                               batch, cpe, **kw)
        same_run((v_gp, g), (v_c, sys_c), f"{name} oracle: card vs CPU")
        same_carry(g, sys_c, f"{name} oracle: card vs CPU")
        print(f"{name} oracle prefix of {len(pre['ts_us'])} packets "
              "(ragged tail): card graph == host driver (fast) on the "
              "card == CPU eager")
        rates = {"oracle": [], "none": []}
        for which in ("none", "oracle", "oracle", "none"):
            sys_ = g if which == "oracle" else plain_sys
            rates[which].append(n / run(sys_, stream)[1])
        print(f"{name} replay (graph, gate cuda) with oracle payloads "
              f"{', '.join(f'{r:.1f}' for r in rates['oracle'])} packets/s"
              f", without {', '.join(f'{r:.1f}' for r in rates['none'])} "
              "packets/s (in turns: none, oracle, oracle, none; with the "
              "oracle's payloads built and staged in each run)")


# -- phase 4d ---------------------------------------------------------------

def phase_capture(ctx):
    """4d. Capture replay: phase 4's flows written as a pcap with its
    label sidecar (``synthesize_pcap``, 1000 packets past the trace: two
    streamed blocks and a ragged tail), ingested back to the source
    stream in every column, then streamed by ``run_trace`` on the CNN
    system whose graphs phase 4 captured: ``TraceSpec`` with overlap on
    and off and a bare path string, each == the in-memory replay of the
    same stream (verdicts, stats, final tensors), with no new capture, 0
    host syncs (the loop runs under sync-debug "error") and the kernel
    counts of the chunks.  Prints the pcap's bytes and the parse-only,
    streaming and in-memory rates."""
    import tempfile
    import types

    from repro_torch.data import trace_ingest as ti

    flows, batch = ctx["flows"], ctx["batch"]
    sys_ = ctx["systems"][("cuda", "graph")]
    n_cap = len(ctx["stream"]["ts_us"]) + 1000
    chunks = -(-n_cap // batch)
    per = gemms_per_chunk(ctx["model"].cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = Path(tmp) / "trace.pcap"
        t0 = time.perf_counter()
        source = ti.synthesize_pcap(flows, path, limit=n_cap)
        synth_s = time.perf_counter() - t0
        require(len(source["ts_us"]) == n_cap, "the capture is short")
        t0 = time.perf_counter()
        got = ti.ingest_pcap(path)
        ingest_s = time.perf_counter() - t0
        require(sorted(got) == sorted(source), "ingested columns differ")
        for k in source:
            require(got[k].dtype == source[k].dtype
                    and np.array_equal(got[k], source[k]),
                    f"ingest: column {k} differs from the source stream")
        print(f"capture: {n_cap} packets, {path.stat().st_size} bytes of "
              f"pcap ({synth_s:.2f} s to write); ingest {ingest_s:.2f} s; "
              "ingested stream == source stream in every column and dtype")
        v_mem, _ = run(sys_, source)          # the in-memory replay
        mem = types.SimpleNamespace(state=sys_.state, queues=sys_.queues,
                                    _dl=sys_._dl, stats=dict(sys_.stats))
        want = {"fused_gate": chunks, "fused_gate_prng": 0,
                "threefry_draw": chunks, "int8_gemm": per * chunks,
                "decode_attention": 0}
        traces = {"overlap on": ti.TraceSpec(path),
                  "overlap off": ti.TraceSpec(path, overlap=False),
                  "in memory": source, "path string": str(path)}
        rates = {}
        # in turns; "parse only" runs TraceSpec.iter_chunks alone
        for what in ("parse only", "overlap on", "overlap off", "in memory",
                     "in memory", "overlap off", "overlap on", "parse only",
                     "path string"):
            if what == "parse only":
                t0 = time.perf_counter()
                cnt = sum(len(c["ts_us"])
                          for c in ti.TraceSpec(path).iter_chunks())
                sec = time.perf_counter() - t0
                require(cnt == n_cap, f"parsed {cnt} packets")
            else:
                zero_counts()
                v, sec = run(sys_, traces[what])
                counts = read_counts()
                same_run((v, sys_), (v_mem, mem), f"{what} vs in memory")
                same_carry(sys_, mem, f"{what} vs in memory")
                require(sys_.capture_s == 0.0 and sys_.host_syncs == 0,
                        f"{what}: a capture or a host sync")
                require(counts == want, f"{what}: launches {counts}; want "
                        f"{want}")
            rates.setdefault(what, []).append(n_cap / sec)
    for what, r in rates.items():
        print(f"capture {what}: {', '.join(f'{x:.1f}' for x in r)} "
              "packets/s (in turns: parse only, overlap on, off, in memory, "
              "in memory, off, on, parse only, path string)")
    print(f"streamed replays (overlap on, off, a path string) == in-memory "
          f"replay (verdicts, stats, final tensors); no capture; 0 host "
          f"syncs; launches {want} each")


# -- phase 4e ---------------------------------------------------------------

# the reference's pinned Table-2 accuracies and its own regression bar on
# them (docs/TRAINING.md, benchmarks/check_regression.py): a flow-level
# macro-F1 may sit at most 0.05 below its pinned value.  The pin was made
# by `benchmarks/run.py --fast`, i.e. bench_accuracy.main(n_flows=250,
# steps=150) (the reference at those settings reproduces it); the
# protocol also runs at bench_accuracy's own defaults (500 flows, 300
# steps), which no pinned value describes, so that run is printed, not
# gated.  (n_flows, steps, gated)
PINNED_ACCURACY = ROOT / "benchmarks" / "results" / "baseline" / \
    "accuracy.json"
F1_BAR = 0.05
PROTOCOLS = ((250, 150, True), (500, 300, False))
TRAIN_STEPS, TRAIN_BATCH = 300, 256


def _split_flows(flows, test_frac=0.25, seed=0):
    """The accuracy protocol's 75/25 split of the flows (a copy of
    ``benchmarks/bench_accuracy.py:_split_flows``)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(flows))
    n_test = int(len(flows) * test_frac)
    return ([flows[i] for i in idx[n_test:]],
            [flows[i] for i in idx[:n_test]])


def _flow_f1(pred, labels, flow_id, k):
    """Macro-F1 of the per-flow majority votes of ``pred``."""
    from repro_torch.baselines.common import flow_vote, macro_f1

    uf, votes = flow_vote(pred, flow_id)
    flow_labels = np.asarray([labels[flow_id == f][0] for f in uf])
    return macro_f1(flow_labels, votes, k), flow_labels, votes


# the nine schemes of Table 2 in the order of bench_accuracy.run_task, and
# the level each is scored at (FENIX at both)
TABLE2 = ("fenix-cnn-pkt", "fenix-cnn-flow", "fenix-rnn-pkt",
          "fenix-rnn-flow", "flowlens-flow", "leo-pkt", "netbeacon-pkt",
          "bos-pkt", "n3ic-pkt")
BASELINE_BATCH = 256


def _train_baseline(loss, params, x, y, steps, k, device, seed=0):
    """bench_accuracy's ``_train_nn`` on the port's Trainer: batch 256
    drawn from ``default_rng(seed)`` with class weights, AdamW lr 3e-3,
    warmup steps // 10, weight decay 0.01; the step a CUDA graph on the
    card.  Returns (trainer, seconds of the run, capture included)."""
    from repro_torch.data.synthetic_traffic import class_weights
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           batch_iterator)

    t = Trainer(loss, params, TrainerConfig(
        total_steps=steps, log_every=10**9,
        opt=OptConfig(lr=3e-3, warmup_steps=steps // 10, total_steps=steps,
                      weight_decay=0.01)), device=device)
    batches = batch_iterator(x, y, BASELINE_BATCH, seed=seed,
                             weights=class_weights(y, k), device=device)
    if t.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.run(batches)
    if t.device.type == "cuda":
        torch.cuda.synchronize()
    return t, time.perf_counter() - t0


def baseline_rows(k, tr_flows, te_flows, steps, device="cuda", seed=0):
    """The five baselines of ``bench_accuracy.run_task`` (:108-159) on the
    port, in its order and with its settings: FlowLens on the flow
    markers (numpy GBDT, the control plane's CPU classifier), Leo and
    NetBeacon fitted in numpy and predicting on ``device``, BoS
    (``fenix_cnn(k)``'s embedding sizes) on the training windows and
    N3IC on its features, each trained by :func:`_train_baseline`.
    Returns {scheme: (macro-F1, seconds, note)}."""
    from repro_torch.baselines import bos, n3ic
    from repro_torch.baselines.common import macro_f1
    from repro_torch.baselines.flowlens import FlowLensModel, markers
    from repro_torch.baselines.leo import LeoModel
    from repro_torch.baselines.netbeacon import NetBeaconModel
    from repro_torch.configs.fenix_models import fenix_cnn
    from repro_torch.data.synthetic_traffic import windows_from_flows
    from repro_torch.models import traffic

    out = {}
    t0 = time.perf_counter()
    xf, yf = markers(tr_flows)
    xfe, yfe = markers(te_flows)
    fl = FlowLensModel(k)
    fl.fit(xf, yf)
    out["flowlens-flow"] = (macro_f1(yfe, fl.predict(xfe), k),
                            time.perf_counter() - t0, "numpy GBDT")
    for name, model in (("leo-pkt", LeoModel(k, device=device)),
                        ("netbeacon-pkt",
                         NetBeaconModel(k, seed=seed, device=device))):
        t0 = time.perf_counter()
        model.fit(tr_flows)
        t1 = time.perf_counter()
        r = model.predict_packets(te_flows)
        out[name] = (macro_f1(r["label"], r["pred"], k),
                     time.perf_counter() - t0,
                     f"fit {t1 - t0:.2f} s (numpy), predict "
                     f"{time.perf_counter() - t1:.4f} s on {device} "
                     f"({len(r['pred'])} checkpoints)")
    xtr, ytr, _ = windows_from_flows(tr_flows, seed=seed)
    xte, yte, _ = windows_from_flows(te_flows, seed=seed + 1)
    cfg = fenix_cnn(k)  # reuse embedding sizes, as the reference does
    table = traffic.ipd_log2_table(device)
    t, sec = _train_baseline(lambda p, b: bos.loss_fn(p, cfg, b, table),
                             bos.init(cfg, seed=seed, device=device),
                             xtr, ytr, steps, k, device, seed)
    with torch.no_grad():
        pred = torch.argmax(bos.apply(t.params, cfg, torch.as_tensor(
            xte).to(device), table), -1).cpu().numpy()
    rate = steps / max(sec - t.capture_s, 1e-9)
    out["bos-pkt"] = (macro_f1(yte, pred, k), sec,
                      f"{steps} steps at {rate:.1f} steps/s on the "
                      f"{t.step_backend} step (capture {t.capture_s:.4f} s)")
    xn, yn, _ = n3ic.build_features(tr_flows)
    xne, yne, _ = n3ic.build_features(te_flows)
    t, sec = _train_baseline(n3ic.loss_fn,
                             n3ic.init(xn.shape[1], k, seed=seed,
                                       device=device),
                             xn, yn, steps, k, device, seed)
    with torch.no_grad():
        pred = torch.argmax(n3ic.apply(t.params, torch.as_tensor(xne).to(
            device)), -1).cpu().numpy()
    rate = steps / max(sec - t.capture_s, 1e-9)
    out["n3ic-pkt"] = (macro_f1(yne, pred, k), sec,
                       f"{steps} steps at {rate:.1f} steps/s on the "
                       f"{t.step_backend} step (capture {t.capture_s:.4f} s)")
    return out


def print_table2(table, pinned, n_flows, steps):
    """Table 2 (9 schemes x 2 tasks) beside the pinned values."""
    print(f"Table 2 on the card ({n_flows} flows, {steps} steps; macro-F1, "
          "pinned reference value, difference):")
    tasks = sorted(table)
    print("  scheme          " + "".join(
        f"{t:>8} {'pinned':>8} {'diff':>8}   " for t in tasks))
    for sch in TABLE2:
        row = "".join(f"{table[t][sch]:8.4f} "
                      f"{pinned[t][sch]['macro_f1']:8.4f} "
                      f"{table[t][sch] - pinned[t][sch]['macro_f1']:+8.4f}   "
                      for t in tasks)
        print(f"  {sch:16}{row}")


def accuracy_protocol():
    """4e part 1: the Table-2 protocol of ``benchmarks/bench_accuracy.py``
    at full width, on the card, at each of ``PROTOCOLS``: for each task
    and each of FENIX-CNN and FENIX-RNN, ``make_flows(task, n_flows,
    seed=0, min_per_class=30)``, the 75/25 flow split,
    ``train_quantized`` (``steps`` steps of 256 windows, lr 3e-3, warmup
    steps // 10, weight decay 0.01, on the train step's graph; the first
    512 training windows calibrate), then ``evaluate_quantized`` on the
    held-out windows with the kernel (``"cuda"``), whose predictions must
    equal the plain backend's.  At the pin's settings the five baselines
    run beside them (:func:`baseline_rows`), the full Table 2 is printed
    beside the pinned values, and each flow-level FENIX macro-F1 and each
    baseline's must reach its pinned reference value minus ``F1_BAR``.
    Returns the models trained on iscx at bench_accuracy's defaults (numpy
    qparams and configs) and their training windows."""
    from repro_torch.baselines.common import confusion_matrix
    from repro_torch.configs.fenix_models import fenix_cnn, fenix_rnn
    from repro_torch.core.model_engine import serving
    from repro_torch.data.synthetic_traffic import (make_flows, task_meta,
                                                    windows_from_flows)

    pinned = json.loads(PINNED_ACCURACY.read_text())
    trained = {}
    for n_flows, steps, gated in PROTOCOLS:
        table = {}
        for task in ("iscx", "ustc"):
            table[task] = row = {}
            k = len(task_meta(task)[0])
            flows = make_flows(task, n_flows, seed=0, min_per_class=30)
            tr_flows, te_flows = _split_flows(flows, seed=0)
            xte, yte, fte = windows_from_flows(te_flows, seed=1)
            for mk, nm in ((fenix_cnn, "fenix-cnn"),
                           (fenix_rnn, "fenix-rnn")):
                mcfg = mk(k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, qp, m = serving.train_quantized(mcfg, tr_flows,
                                                   steps=steps, seed=0,
                                                   batch=TRAIN_BATCH)
                train_s = time.perf_counter() - t0
                ev = serving.evaluate_quantized(qp, mcfg, xte, yte,
                                                backend="cuda")
                ev_ref = serving.evaluate_quantized(qp, mcfg, xte, yte,
                                                    backend="ref")
                require(np.array_equal(ev["pred"], ev_ref["pred"]),
                        f"{task} {nm}: evaluate_quantized cuda != ref")
                flow_f1, flow_y, votes = _flow_f1(ev["pred"], yte, fte, k)
                want_pkt = pinned[task][f"{nm}-pkt"]["macro_f1"]
                want_flow = pinned[task][f"{nm}-flow"]["macro_f1"]
                gate = (f"bar {want_flow - F1_BAR:.4f}" if gated else
                        "not gated: the pin is of 250 flows, 150 steps")
                print(f"accuracy {task} {nm}, {n_flows} flows, {steps} "
                      f"steps ({len(tr_flows)} train / {len(te_flows)} "
                      f"test flows, {len(yte)} test windows; trained in "
                      f"{train_s:.2f} s incl. windows, capture and "
                      f"quantization; final loss {m['loss']:.4f}): packet "
                      f"macro-F1 {ev['macro_f1']:.4f} (pinned "
                      f"{want_pkt:.4f}), flow macro-F1 {flow_f1:.4f} "
                      f"(pinned {want_flow:.4f}, {gate}); "
                      "evaluate_quantized cuda == ref")
                print(f"  confusion (packet): {ev['confusion']}")
                print("  confusion (flow): "
                      f"{confusion_matrix(flow_y, votes, k).tolist()}")
                row[f"{nm}-pkt"], row[f"{nm}-flow"] = ev["macro_f1"], flow_f1
                if gated:
                    require(flow_f1 >= want_flow - F1_BAR,
                            f"{task} {nm}: flow macro-F1 {flow_f1:.4f} "
                            f"below {want_flow:.4f} - {F1_BAR}")
                elif task == "iscx":
                    trained[nm] = (mcfg, qp)
            if task == "iscx" and not gated:
                x, y, _ = windows_from_flows(tr_flows, seed=0)
                trained["windows"] = (x, y)
            if not gated:
                continue
            for sch, (f1, sec, note) in baseline_rows(
                    k, tr_flows, te_flows, steps).items():
                want = pinned[task][sch]["macro_f1"]
                row[sch] = f1
                print(f"accuracy {task} {sch}, {n_flows} flows, {steps} "
                      f"steps: macro-F1 {f1:.4f} (pinned {want:.4f}, "
                      f"difference {f1 - want:+.6f}, bar "
                      f"{want - F1_BAR:.4f}); {sec:.2f} s; {note}")
                require(f1 >= want - F1_BAR,
                        f"{task} {sch}: macro-F1 {f1:.4f} below "
                        f"{want:.4f} - {F1_BAR}")
        if gated:
            print_table2(table, pinned, n_flows, steps)
    return trained


class PlantNaN:
    """The batches of ``inner`` (a ``Batches``) with every weight NaN in
    the first one.  At the next draw it checks that the step on the NaN
    batch left every param, moment and the counter of ``trainer`` as
    they were, then restores the weights."""

    def __init__(self, inner, trainer):
        self.inner, self.trainer = inner, trainer
        self.data = inner.data
        self.calls, self.checked = 0, False

    def __iter__(self):
        return self

    def _state(self):
        t = self.trainer
        return {"params": dict(t.params), "m": dict(t.opt_state["m"]),
                "v": dict(t.opt_state["v"]), "step": t.opt_state["step"]}

    def __next__(self):
        from repro_torch._graph import clone

        self.calls += 1
        w = self.data["weight"]
        if self.calls == 1:
            self.before = clone(self._state())
            self.saved = w.clone()
            w.fill_(float("nan"))
        elif self.calls == 2:
            now = self._state()
            for part, leaves in self.before.items():
                if isinstance(leaves, dict):
                    for k, v in leaves.items():
                        require(torch.equal(v, now[part][k]),
                                f"a NaN step moved {part}[{k!r}]")
                else:
                    require(torch.equal(leaves, now[part]),
                            "a NaN step moved the step counter")
            w.copy_(self.saved)
            self.checked = True
        return next(self.inner)


def _trainers(mcfg, x, y, steps, seed):
    """A graph and an eager trainer of ``mcfg`` from one init, and their
    batches (one draw sequence each, from the same seed)."""
    from repro_torch.data.synthetic_traffic import class_weights
    from repro_torch.models import traffic
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           batch_iterator)

    table = traffic.ipd_log2_table("cuda")
    params = traffic.init(mcfg, seed=seed, device="cuda")
    w = class_weights(y, mcfg.num_classes)
    opt = OptConfig(lr=3e-3, warmup_steps=TRAIN_STEPS // 10,
                    total_steps=TRAIN_STEPS, weight_decay=0.01)
    out = {}
    for step in ("graph", "eager"):
        t = Trainer(lambda p, b: traffic.loss_fn(p, mcfg, b, table), params,
                    TrainerConfig(total_steps=steps, log_every=1, opt=opt,
                                  step_backend=step), device="cuda")
        out[step] = (t, batch_iterator(x, y, TRAIN_BATCH, seed=seed,
                                       weights=w, device="cuda"))
    return out


def _count_syncs(run):
    """Host syncs of ``run()``: the warnings of sync-debug "warn"."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum("synchroniz" in str(c.message) for c in caught)


def _profile_run(run):
    """``run()`` under torch.profiler: (its seconds, the device events by
    device time, the device busy seconds, launch calls, memcpy calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run()
    sec = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                 key=_dev_us, reverse=True)
    busy = sum(_dev_us(a) for a in dev) / 1e6
    return (sec, dev, busy, *_launches(avgs))


def _train_profile(t, batches, steps, what):
    """``steps`` steps timed, then as many under torch.profiler: launch
    calls a step, device busy time and the idle share (against the
    steps without the profiler); and host syncs a step, counted by the
    warnings of sync-debug "warn" over as many steps again."""
    def run():
        t.run(batches, steps=steps)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    sec_plain = time.perf_counter() - t0
    sec, _, busy, n_launch, n_copy = _profile_run(run)
    syncs = _count_syncs(run)
    print(f"training profile ({what}): {steps} steps, {sec:.4f} s under the "
          f"profiler, device busy {busy:.4f} s = {busy / steps * 1e3:.4f} ms "
          f"a step, idle share {1 - busy / sec_plain:.3f} against the same "
          f"steps without the profiler ({sec_plain:.4f} s; "
          f"{1 - busy / sec:.3f} under it); {n_launch / steps:.2f} launch "
          "calls and "
          f"{n_copy / steps:.2f} memcpy calls a step; {syncs / steps:.2f} "
          "host syncs a step (sync-debug warnings)")
    return n_launch / steps, syncs / steps


def train_step_check(name, mcfg, x, y, seed):
    """4e part 2a: the train step's graph against the eager step on the
    card, from one init over 20 steps: losses (every step's metrics),
    params, moments and the counter bit for bit; then a planted NaN batch
    on each leaves the state untouched and counts one recovery; then the
    training rate of both in turns, launch calls and host syncs a step,
    and capture seconds."""
    steps = 20
    tr = _trainers(mcfg, x, y, steps, seed)
    for step, (t, batches) in tr.items():
        t.run(batches)
        require(t.step == steps and t.recoveries == 0,
                f"{name} {step}: {t.step} steps, {t.recoveries} recoveries")
    (g, _), (e, _) = tr["graph"], tr["eager"]
    require(g.metrics_log == e.metrics_log,
            f"{name}: graph and eager metrics differ")
    for part, a, b in (("params", g.params, e.params),
                       ("m", g.opt_state["m"], e.opt_state["m"]),
                       ("v", g.opt_state["v"], e.opt_state["v"])):
        for k in a:
            require(torch.equal(a[k], b[k]),
                    f"{name}: graph {part}[{k!r}] != eager, max |diff| "
                    f"{max_abs_diff(a[k], b[k])}")
    require(torch.equal(g.opt_state["step"], e.opt_state["step"])
            and int(g.opt_state["step"]) == steps, f"{name}: step counter")
    losses = [m["loss"] for m in g.metrics_log]
    print(f"train step {name}: graph == eager over {steps} steps from one "
          f"init (every step's metrics, params, m, v, step bit for bit); "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; graph captured in "
          f"{g.capture_s:.4f} s (warm-up on copies of params and moments + "
          "capture)")
    for step, (t, batches) in tr.items():
        plant = PlantNaN(batches, t)
        t.run(plant, steps=1)
        require(plant.checked and t.recoveries == 1
                and t.step == steps + 1,
                f"{name} {step}: NaN batch: recoveries {t.recoveries}, "
                f"step {t.step}")
    print(f"train step {name}: a NaN batch left every param, moment and "
          "the counter unchanged and counted one recovery (graph and eager)")
    # the training rate, in turns: eager, graph, graph, eager
    n = 100
    rate = {}
    for step in ("eager", "graph", "graph", "eager"):
        t, batches = tr[step]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.run(batches, steps=n)
        rate.setdefault(step, []).append(n / (time.perf_counter() - t0))
    prof = {step: _train_profile(*tr[step], 20, f"{name}, {step}")
            for step in ("graph", "eager")}
    require(prof["graph"][0] <= 2,
            f"{name}: {prof['graph'][0]} launch calls a graph step")
    for step in ("graph", "eager"):
        print(f"training rate {name} ({step}): "
              f"{', '.join(f'{r:.1f}' for r in rate[step])} steps/s = "
              f"{', '.join(f'{r * TRAIN_BATCH:.0f}' for r in rate[step])} "
              f"windows/s (in turns: eager, graph, graph, eager; batch "
              f"{TRAIN_BATCH}); {prof[step][0]:.2f} launch calls and "
              f"{prof[step][1]:.2f} host syncs a step; capture "
              f"{tr[step][0].capture_s:.4f} s")
    return rate


def replay_trained(name, model, ctx, tree, oracle):
    """4e part 2b: phase 4's trace replayed by the trained model with the
    switch tree and oracle payloads (``examples/fenix_e2e.py``): graph ==
    eager on each gate kernel (verdicts, stats, final tensors, counts),
    == the plain backends; packets/s beside verdict coverage, per-packet
    accuracy and flow macro-F1.  Returns the graph replays' int8_gemm
    launches (counts at 0 just before each)."""
    stream, batch, cpe = ctx["stream"], ctx["batch"], ctx["cpe"]
    n = len(stream["ts_us"])
    chunks = -(-n // batch)
    per = gemms_per_chunk(model.cfg)
    kw = dict(tree=tree, sys_kw=dict(oracle_windows=oracle))
    warm = {k: v[:(cpe + 1) * batch] for k, v in stream.items()}
    gemms, res = 0, {}
    for gate in ("cuda", "cuda_prng"):
        g = make_system(model, "cuda", batch, cpe, gate_backend=gate, **kw)
        e = make_system(model, "cuda", batch, cpe, gate_backend=gate,
                        step_backend="eager", **kw)
        run(g, warm)                                       # capture
        want = {"fused_gate": chunks if gate == "cuda" else 0,
                "fused_gate_prng": chunks if gate == "cuda_prng" else 0,
                "threefry_draw": chunks, "int8_gemm": per * chunks,
                "decode_attention": 0}
        runs = {}
        for step, sys_ in (("graph", g), ("eager", e)):
            v, sec, counts = counted_run(sys_, stream)
            require(counts == want, f"{name} {gate} {step}: launches "
                    f"{counts}; want {want}")
            require(sys_.host_syncs == 0 and sys_.capture_s == 0.0,
                    f"{name} {gate} {step}: host syncs or a new capture")
            runs[step] = (v, sys_)
        gemms += want["int8_gemm"]
        same_run(runs["graph"], runs["eager"], f"{name} {gate}: graph vs "
                 "eager")
        same_carry(g, e, f"{name} {gate}: graph vs eager")
        res[gate] = runs["graph"]
    plain = make_system(model, "cuda", batch, cpe, gate_backend="ref",
                        matmul_backend="ref", **kw)
    v_p = run(plain, stream)[0]
    same_run(res["cuda"], (v_p, plain), f"{name}: cuda vs plain")
    same_run(res["cuda_prng"], res["cuda"], f"{name}: cuda_prng vs cuda")
    rate = {}
    for gate in ("cuda", "cuda_prng", "cuda_prng", "cuda"):
        rate.setdefault(gate, []).append(n / run(res[gate][1], stream)[1])
    v, sys_ = res["cuda"]
    lab, fidx = stream["label"], stream["flow_idx"]
    mask = v >= 0
    pkt_acc = float(np.mean(v[mask] == lab[mask]))
    flow_f1, _, _ = _flow_f1(v[mask], lab[mask], fidx[mask],
                             model.cfg.num_classes)
    print(f"trained {name} replay, {n} packets with the tree and oracle "
          f"payloads: graph == eager (gate cuda and cuda_prng) == plain "
          f"backends; launches {want['int8_gemm']} int8_gemm a gate "
          f"({per} x {chunks} chunks); graph "
          f"{', '.join(f'{r:.1f}' for r in rate['cuda'])} packets/s "
          f"(cuda), {', '.join(f'{r:.1f}' for r in rate['cuda_prng'])} "
          f"(cuda_prng) (in turns: cuda, cuda_prng, cuda_prng, cuda); "
          f"verdict coverage {mask.mean():.4f}, per-packet accuracy "
          f"{pkt_acc:.4f}, flow macro-F1 {flow_f1:.4f}; stats {sys_.stats}")
    require(sys_.stats["classified_pkts"] > 0 and mask.any(),
            f"{name}: the replay classified no packet")
    return gemms


def phase_training(ctx):
    """4e. Training on the card: the accuracy protocol (part 1), then
    the train step's graph against the eager step, NaN recovery and the
    training rate for the full-width CNN and RNN, and phase 4's trace
    replayed by the iscx-trained models (part 2).  Returns the replays'
    int8_gemm launches."""
    from repro_torch.core.data_engine.decision_tree import (fit_tree,
                                                            tree_arrays)
    from repro_torch.core.model_engine import serving
    from repro_torch.core.model_engine.inference import EngineModel

    trained = accuracy_protocol()
    x, y = trained.pop("windows")
    for name, (mcfg, _) in trained.items():
        train_step_check(name, mcfg, x, y, seed=0)
    k = trained["fenix-cnn"][0].num_classes
    tree = tree_arrays(fit_tree(x[:, -1, :], y, depth=4, num_classes=k),
                       "cuda")
    oracle = [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
              for f in ctx["flows"]]
    gemms = 0
    for name, (mcfg, qp) in trained.items():
        model = EngineModel(mcfg, serving.qparams_from_numpy(qp, "cuda"))
        gemms += replay_trained(name, model, ctx, tree, oracle)
    return gemms


# -- phase 4f ---------------------------------------------------------------

PIPES, ENGINES = 4, 4        # a Tofino's four ingress pipelines; 4 engines


def same_pipes_carry(a, b, what):
    """Identical final stacked state, queues and delay lines (and the
    farm's engine queues) of two pipes / farm systems."""
    names = ("pstate", "pqueues", "pdl") + (("eq",) if a._use_farm else ())
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        require(sorted(x) == sorted(y), f"{what}: {name} keys differ")
        for k in x:
            require(torch.equal(x[k].cpu(), y[k].cpu()),
                    f"{what}: {name}[{k!r}] differs")


def _rounds(sys_, stream):
    """(uniform steps, pipes with a tail) of a pipes / farm replay."""
    _, _, counts = sys_._route_pipes(stream)
    b = sys_.cfg.batch_size
    return int((counts // b).max()), int((counts % b > 0).sum())


def _tail_free(sys_, stream):
    """``stream`` with each pipe's last (< batch) packets dropped: every
    step of its replay is a uniform one (a graph replay on graphs)."""
    order, starts, counts = sys_._route_pipes(stream)
    b = sys_.cfg.batch_size
    keep = np.concatenate([order[st:st + c // b * b]
                           for st, c in zip(starts, counts)])
    keep.sort()
    return {k: np.asarray(v)[keep] for k, v in stream.items()}


def drive_pipes(model, stream, batch, cpe, driver, num_pipes, num_engines):
    """The pipes or farm driver's main path on the trace: each gate
    kernel on graphs (captured on a warm-up prefix) and eagerly, each
    kernel count at 0 before each replay: one gate launch a uniform step
    whatever P plus one a tail, six GEMM launches a step (one flattened
    call a layer); graph == eager (verdicts, stats, final tensors,
    counts) == the plain backends; packets/s of graph and eager in turns;
    the profiles.  Returns the systems and the main path's counts."""
    n = len(stream["ts_us"])
    kw = dict(driver=driver, num_pipes=num_pipes, num_engines=num_engines)
    gates = ("cuda", "cuda_prng")
    systems = {(gate, step): make_system(model, "cuda", batch, cpe,
                                         gate_backend=gate,
                                         step_backend=step, **kw)
               for gate in gates for step in ("graph", "eager")}
    plain = make_system(model, "cuda", batch, cpe, gate_backend="ref",
                        matmul_backend="ref", **kw)
    what = f"{driver} P={num_pipes}" + (f" x E={num_engines}"
                                        if driver == "farm" else "")
    steps, tails = _rounds(plain, stream)
    per = gemms_per_chunk(model.cfg)
    warm = {k: v[:(cpe + 1) * batch * num_pipes] for k, v in stream.items()}
    for sys_ in (*systems.values(), plain):
        run(sys_, warm)
    for gate in gates:
        g = systems[(gate, "graph")]
        require(sorted(g._graphs) == [False, True], f"{what}: graphs")
        print(f"{what} capture (gate {gate}): both step graphs in "
              f"{g.capture_s:.4f} s, outside every timed replay")
    want = {"cuda": {"fused_gate": steps + tails, "fused_gate_prng": 0,
                     "threefry_draw": steps + tails,
                     "int8_gemm": per * (steps + tails),
                     "decode_attention": 0},
            "cuda_prng": {"fused_gate": 0, "fused_gate_prng": steps + tails,
                          "threefry_draw": steps + tails,
                          "int8_gemm": per * (steps + tails),
                          "decode_attention": 0}}
    res, counted = {}, {}
    for gate in gates:
        for step in ("graph", "eager"):
            sys_ = systems[(gate, step)]
            v, sec, counted[(gate, step)] = counted_run(sys_, stream)
            require(counted[(gate, step)] == want[gate],
                    f"{what}: launches {counted[(gate, step)]} for {steps} "
                    f"steps and {tails} tails (gate {gate}, {step}); want "
                    f"{want[gate]}")
            require(sys_.host_syncs == 0 and sys_.capture_s == 0.0,
                    f"{what} gate {gate} {step}: host syncs or a capture")
            res[(gate, step)] = (v, sys_, sec)
        same_run(res[(gate, "graph")], res[(gate, "eager")],
                 f"{what} gate {gate}: graph vs eager")
        same_pipes_carry(res[(gate, "graph")][1], res[(gate, "eager")][1],
                         f"{what} gate {gate}: graph vs eager")
    v_r, _, launches_r = counted_run(plain, stream)
    require(not any(launches_r.values()),
            f"{what}: the plain-backend replay launched {launches_r}")
    v_k, sys_k, _ = res[("cuda", "graph")]
    same_run((v_k, sys_k), (v_r, plain), f"{what}: gate cuda vs plain")
    same_pipes_carry(sys_k, plain, f"{what}: gate cuda vs plain")
    same_run(res[("cuda_prng", "graph")], (v_k, sys_k),
             f"{what}: gate cuda_prng vs cuda")
    st = sys_k.stats
    require(v_k.shape == (n,) and v_k.min() >= -1
            and v_k.max() < model.cfg.num_classes, f"{what}: verdicts")
    require(st["inferences"] > 0 and st["classified_pkts"] > 0
            and st["dropped_eq"] == 0, f"{what}: stats {st}")
    print(f"{what}: graph == eager == plain backends (verdicts, stats, "
          f"state, queues, delay lines{', engine queues' if driver == 'farm' else ''}) "
          f"for gate cuda and cuda_prng; 0 host syncs; {steps} uniform "
          f"steps + {tails} tails: launches {counted[('cuda', 'graph')]} "
          f"(one gate launch a step and a tail, {per} GEMMs each)")
    print(f"{what} stats: inferences {st['inferences']}, granted "
          f"{st['granted']}, classified {st['classified_pkts']}/{n}, "
          f"served_per_engine {st['served_per_engine']}, dropped_q "
          f"{st['dropped_q']}, dropped_inflight {st['dropped_inflight']}, "
          f"engine_q_depth_hist {st['engine_q_depth_hist']}")
    rate = {}
    for gate in gates:
        for step in ("eager", "graph", "graph", "eager"):
            sec = run(systems[(gate, step)], stream)[1]
            rate.setdefault((gate, step), []).append(n / sec)
        print(f"{what} replay (gate {gate}): graph "
              f"{', '.join(f'{r:.1f}' for r in rate[(gate, 'graph')])} "
              f"packets/s; eager "
              f"{', '.join(f'{r:.1f}' for r in rate[(gate, 'eager')])} "
              "packets/s (in turns: eager, graph, graph, eager)")
    # the profiles, on the trace cut to whole batches a pipe (a replay of
    # uniform steps only: the tails run eagerly, apart from the graphs)
    free = _tail_free(plain, stream)
    steps_f, tails_f = _rounds(plain, free)
    require(tails_f == 0, f"{what}: the tail-free trace has tails")
    sec_t = run(systems[("cuda", "graph")], stream)[1]
    sec_f = run(systems[("cuda", "graph")], free)[1]
    print(f"{what}: the trace's {tails} tails take "
          f"{sec_t - sec_f * steps / steps_f:.4f} s of the {sec_t:.4f} s "
          f"replay (graph, gate cuda; the same trace without them "
          f"{sec_f:.4f} s for {steps_f} steps)")
    for gate in gates:
        for step in ("graph", "eager"):
            profile_replay(systems[(gate, step)], free, steps_f,
                           f"{what}, gate {gate}, {step}, no tails")
    return {"systems": systems, "res": res, "launches": counted,
            "steps": steps, "tails": tails}


def phase_pipes(ctx):
    """4f. The multi-pipe driver (P=4) and the engine farm (P=4 x E=4) on
    phase 4's trace and full-width CNN: each gate kernel, graph == eager
    == plain; P=1 pipes == phase 4's device replay; E=1 farm == P=4
    pipes; the card == the CPU on a prefix with ragged tails.  Returns the
    launches of the pipe-batched gate and of the GEMM on both main
    paths."""
    stream, model = ctx["stream"], ctx["model"]
    batch, cpe = ctx["batch"], ctx["cpe"]
    out = {}
    for driver, engines in (("pipes", 1), ("farm", ENGINES)):
        d = drive_pipes(model, stream, batch, cpe, driver, PIPES, engines)
        out[driver] = d
        del d["systems"]

    # P=1 pipes == the device driver's replay of phase 4
    v_dev, stats_dev, state_dev = ctx["device_run"]
    one = make_system(model, "cuda", batch, cpe, driver="pipes",
                      num_pipes=1)
    run(one, {k: v[:(cpe + 1) * batch] for k, v in stream.items()})
    v_one = run(one, stream)[0]
    require(np.array_equal(v_one, v_dev) and one.stats == stats_dev,
            "pipes P=1 vs the device driver: verdicts or stats differ")
    for k, v in state_dev.items():
        require(torch.equal(one.pstate[k][0], v),
                f"pipes P=1 vs the device driver: state {k!r} differs")
    print("pipes P=1 (graph) == phase 4's device replay (verdicts, stats, "
          "state) on the card")
    del one

    # E=1 farm == P=4 pipes
    farm1 = make_system(model, "cuda", batch, cpe, driver="farm",
                        num_pipes=PIPES, num_engines=1)
    pipes = make_system(model, "cuda", batch, cpe, driver="pipes",
                        num_pipes=PIPES)
    runs = [(run(x, stream)[0], x) for x in (farm1, pipes)]
    same_run(*runs, f"farm E=1 vs pipes P={PIPES}")
    for name in ("pstate", "pqueues", "pdl"):
        for k, v in getattr(pipes, name).items():
            require(torch.equal(getattr(farm1, name)[k], v),
                    f"farm E=1 vs pipes: {name}[{k!r}] differs")
    print(f"farm P={PIPES} x E=1 == pipes P={PIPES} (verdicts, stats, "
          "state, queues, delay lines) on the card")
    del farm1, pipes

    # the card (graph) against the CPU (eager) on a prefix with tails and
    # a T_w window's end (the batched LUT rebuild on both)
    pre = {k: v[:int((cpe + 0.3) * PIPES * batch)]
           for k, v in stream.items()}
    model_cpu = copy.deepcopy(model).to("cpu")
    for driver, engines in (("pipes", 1), ("farm", ENGINES)):
        sides = {}
        for dev, m in (("cuda", model), ("cpu", model_cpu)):
            sys_ = make_system(m, dev, batch, cpe, driver=driver,
                               num_pipes=PIPES, num_engines=engines)
            t0 = time.perf_counter()
            sides[dev] = (run(sys_, pre)[0], sys_,
                          time.perf_counter() - t0)
        steps, tails = _rounds(sides["cpu"][1], pre)
        require(tails > 0 and steps >= cpe,
                f"{driver}: the prefix has {steps} steps, {tails} tails")
        same_run(sides["cuda"][:2], sides["cpu"][:2],
                 f"{driver}: card vs CPU prefix")
        same_pipes_carry(sides["cuda"][1], sides["cpu"][1],
                         f"{driver}: card vs CPU prefix")
        print(f"{driver} (E={engines}) prefix of {len(pre['ts_us'])} "
              f"packets ({steps} steps, {tails} tails): card (graph, "
              f"{sides['cuda'][2]:.3f} s with capture) == CPU (eager, "
              f"{sides['cpu'][2]:.3f} s): verdicts, stats, final tensors")
    del model_cpu
    counts = {}
    for driver in ("pipes", "farm"):
        c = out[driver]["launches"]
        counts[driver] = {
            "fused_gate": c[("cuda", "graph")]["fused_gate"],
            "fused_gate_prng": c[("cuda_prng", "graph")]["fused_gate_prng"],
            "int8_gemm": c[("cuda", "graph")]["int8_gemm"]}
    print(f"launches on the pipes and farm main paths (graph): {counts}")
    return {k: sum(c[k] for c in counts.values())
            for k in ("fused_gate", "fused_gate_prng", "int8_gemm")}


# -- phase 5 ----------------------------------------------------------------

# Tolerance of the kernel against its plain version, element by element:
# 1e-5 in float32 (the reference's own bound); in bfloat16 one ulp of the
# plain output (2^-7 |plain|: both round a float32 result that agrees to
# ~1e-6 to bfloat16, so they differ by at most one step) plus 1e-5.  A
# planted fault (the kernel fed lengths one 128-row tile short) must break it.
ATTN_ULPS = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
ATTN_ATOL = 1e-5


def _attn_inputs(rng, b, hkv, g, d, s, dtype, lens):
    """q [b, hkv*g, d], k, v [b, s, hkv, d] standard normal, drawn on the
    card from a generator seeded by ``rng``; lengths [b] int32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(0, 2**63)))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (rnd(b, hkv * g, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d),
            torch.from_numpy(np.asarray(lens, np.int32)).cuda())


def _attn_err(q, k, v, lens, kernel_lens=None):
    """(max |kernel - plain|, max of |kernel - plain| over its per-element
    tolerance) over rows with keys; an empty row must be 0.  The kernel
    reads ``kernel_lens`` (default ``lens``: a shorter one plants a fault)."""
    from repro_torch.kernels.decode_attention import ops

    got = ops.decode_attention(q, k, v, lens if kernel_lens is None
                               else kernel_lens, backend="cuda")
    want = ops.decode_attention(q, k, v, lens, backend="ref")
    torch.cuda.synchronize()
    keys = lens > 0
    require(bool(torch.all(got[~keys] == 0)), "empty row gave non-zero")
    require(bool(torch.isfinite(got).all()), "non-finite kernel output")
    if not bool(keys.any()):
        return 0.0, 0.0
    want = want[keys].float()
    diff = (got[keys].float() - want).abs()
    tol = ATTN_ULPS[v.dtype] * want.abs() + ATTN_ATOL
    return float(diff.max()), float((diff / tol).max())


def _attn_bound(q, k, lens):
    """Bytes: the valid K/V rows, q and out, each once; operations: the
    two products (4 * len * Hq * D) at the bfloat16 tensor rate."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    rows = int(lens.clamp_min(0).sum())
    byts = 2 * rows * hkv * d * k.element_size() + 2 * q.numel() \
        * q.element_size()
    t_b = byts / HBM_BYTES_PER_S
    t_o = 4.0 * rows * hq * d / (BF16_OPS_PER_S if k.dtype == torch.bfloat16
                                 else FP32_OPS_PER_S)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations", byts


def _sdpa(q, k, v, lens):
    """The library yardstick: one scaled_dot_product_attention call with
    a length mask over the cache's own layout (transposed views)."""
    import torch.nn.functional as F

    mask = torch.arange(k.shape[1], device=k.device)[None, None, None, :] \
        < lens[:, None, None, None]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True)


def cold_ms(calls, reps=3):
    """Device ms per call of a CUDA graph that runs ``calls`` in turn
    (each on its own inputs, so a cache larger than the 50 MB L2 is read
    from HBM as in a decode step over many layers)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
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
    return start.elapsed_time(end) / (reps * len(calls))


def phase_attention(rng, decode_s):
    """Decode attention against its plain version at every listed shape;
    returns the kernels-line row at the Llama decode shape (cache length
    ``decode_s``)."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}   # max |diff|
    ratio = {torch.float32: 0.0, torch.bfloat16: 0.0}   # over tolerance

    def check(dtype, x):
        err, r = _attn_err(*x)
        worst[dtype] = max(worst[dtype], err)
        ratio[dtype] = max(ratio[dtype], r)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 128, 256):
            for g in (1, 4, 5, 8):
                s = int(rng.integers(129, 700))
                lens = [s, 1, 0] + list(rng.integers(1, s + 1, 2))
                x = _attn_inputs(rng, 5, 2, g, d, s, dtype, lens)
                err = check(dtype, x)
                bound, by, _ = _attn_bound(x[0], x[1], x[3])
                print(f"decode_attention {str(dtype)[6:]} B=5 S={s} Hkv=2 "
                      f"G={g} D={d}: max|diff| {err:.3g}; kernel "
                      f"{device_ms(lambda: decode_attention(*x)):.5f} ms, "
                      f"plain {device_ms(lambda: decode_attention_ref(*x)):.5f}"
                      f" ms, sdpa {device_ms(_sdpa(*x)):.5f} ms (device "
                      f"time, graph replay); bound {bound:.7f} ms ({by})")
        print(f"decode_attention {str(dtype)[6:]}: D in 16..256 x G in "
              f"(1, 4, 5, 8), ragged S, lengths with 1, S, 0: max|diff| "
              f"{worst[dtype]:.3g}, at most {ratio[dtype]:.3g} of the "
              f"per-element tolerance ({ATTN_ULPS[dtype]:.3g} |plain| + "
              f"{ATTN_ATOL})")
        # groups above one head tile of 8 (the TPU kernel takes any):
        # ceil(G / 8) CTAs a KV head, the last tile masked
        for g in (9, 12, 16, 32):
            for d in (128, 256):
                s = int(rng.integers(129, 700))
                lens = [s, 1, 0] + list(rng.integers(1, s + 1, 2))
                x = _attn_inputs(rng, 5, 2, g, d, s, dtype, lens)
                err = check(dtype, x)
                print(f"decode_attention {str(dtype)[6:]} B=5 S={s} Hkv=2 "
                      f"G={g} D={d}: max|diff| {err:.3g}")
    # the Llama and qwen2-moe decode shapes (llama3.2-1b: Hkv 8, G 4,
    # D 64; qwen2-moe-a2.7b: Hkv 16, G 1 padded to 16 MMA rows, D 128;
    # batch 8, the generate's cache length) with ragged lengths, and the
    # long-context shape, bfloat16, each also with a planted fault: the
    # kernel reads every row one 128-row tile short, which the tolerance
    # must catch
    b, hkv, g, d = 8, 8, 4, 64
    lens = [decode_s] + list(rng.integers(1, decode_s + 1, b - 2)) + [0]
    llama_in = _attn_inputs(rng, b, hkv, g, d, decode_s, torch.bfloat16,
                            lens)
    moe_in = _attn_inputs(rng, b, 16, 1, 128, decode_s, torch.bfloat16,
                          [decode_s] + list(rng.integers(1, decode_s + 1,
                                                         b - 2)) + [0])
    # recurrentgemma-9b's decode shape: 16 query heads over one KV head
    # (two head tiles), D 256, a ring of 2048 slots, full in two rows
    rg_in = _attn_inputs(rng, 8, RG_HKV, RG_G, RG_D, RG_WIN, torch.bfloat16,
                         [RG_WIN, RG_WIN] + list(rng.integers(1, RG_WIN, 5))
                         + [0])
    # its long_500k decode: batch 1, the ring full
    rg_long_in = _attn_inputs(rng, 1, RG_HKV, RG_G, RG_D, RG_WIN,
                              torch.bfloat16, [RG_WIN])
    long_s = 32768
    long_in = _attn_inputs(rng, 32, hkv, g, d, long_s, torch.bfloat16,
                           rng.integers(long_s // 2, long_s + 1, 32))
    # the cross-attention families' four decode shapes (batch 8): self
    # attention over the generate's cache with ragged lengths, cross
    # attention with every row at the full source length
    cross_in = [(name, _attn_inputs(rng, 8, c_hkv, c_g, c_d, keys,
                                    torch.bfloat16, lens))
                for name, c_hkv, c_g, c_d, keys, lens
                in _cross_shapes(rng, decode_s)]
    for name, x in (("Llama decode shape", llama_in),
                    ("qwen2-moe decode shape", moe_in),
                    ("recurrentgemma decode shape", rg_in),
                    ("recurrentgemma long_500k decode shape", rg_long_in),
                    *cross_in,
                    (f"B=32 S={long_s}", long_in)):
        err = check(torch.bfloat16, x)
        lens_x = x[3]
        short = torch.where(lens_x > 128, lens_x - 128, lens_x)
        f_err, f_ratio = _attn_err(*x, kernel_lens=short)
        print(f"decode_attention bf16 at the {name}: max|diff| {err:.3g}; "
              f"planted fault (last tile skipped): max|diff| {f_err:.3g}, "
              f"{f_ratio:.3g} times the per-element tolerance")
        require(f_ratio > 1.0, f"decode_attention: the bf16 tolerance does "
                f"not catch a skipped tile at the {name}")
    print(f"decode_attention bf16, all shapes: max|diff| "
          f"{worst[torch.bfloat16]:.3g}, at most "
          f"{ratio[torch.bfloat16]:.3g} of the per-element tolerance")
    for dtype, r in ratio.items():
        require(r <= 1.0, f"decode_attention {dtype} max|diff| "
                f"{worst[dtype]} over its tolerance ({r:.3g} of it)")
    del llama_in, moe_in, rg_in, rg_long_in, cross_in

    # timing at the decode shape: lengths mid-decode, four caches in turn
    # (4 x 34 MB > L2), as the 16 layers of one step read 16 caches
    from repro_torch.kernels.decode_attention.kernel import (
        max_active_clusters, num_splits, sm_count, tile_rows)

    sms = sm_count(torch.device("cuda"))
    lens = [decode_s - 16] * b
    sets = [_attn_inputs(rng, b, hkv, g, d, decode_s, torch.bfloat16, lens)
            for _ in range(4)]
    rows = tile_rows(d, 2, True)
    splits = num_splits(b, hkv, decode_s, rows, sms)
    resident = max_active_clusters(b, hkv, g, d, torch.bfloat16,
                                   torch.bfloat16, splits)
    # kernel and SDPA in turns (kernel, sdpa, kernel, sdpa): the second
    # reading of each is kept, the first only warms the card up
    turns = [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
             cold_ms([_sdpa(*x) for x in sets])]
    turns += [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
              cold_ms([_sdpa(*x) for x in sets])]
    ms, lib_ms = turns[2], turns[3]
    plain_ms = cold_ms([lambda x=x: decode_attention_ref(*x) for x in sets])
    print("  decode shape in turns (kernel, sdpa, kernel, sdpa): "
          + ", ".join(f"{t:.5f}" for t in turns) + " ms")
    bound, by, byts = _attn_bound(sets[0][0], sets[0][1], sets[0][3])
    print(f"decode_attention Llama decode shape B={b} S={decode_s} Hkv={hkv} "
          f"Hq={hkv * g} D={d} bf16 (lengths {lens[0]}): kernel {ms:.5f} ms "
          f"with {splits} splits ({b * hkv * splits} CTAs on {sms} SMs, "
          f"{resident} clusters resident at most), plain {plain_ms:.5f} "
          f"ms, sdpa {lib_ms:.5f} ms (device time, graph replay over 4 "
          f"caches); bound {bound:.5f} ms ({by}, {byts / 1e6:.1f} MB); "
          f"kernel at {byts / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the "
          f"bound, {lib_ms / ms:.3f}x sdpa's speed")
    for sp in (1, 2, 4, 8):
        if sp != splits:
            t = cold_ms([lambda x=x: decode_attention(*x, splits=sp)
                         for x in sets])
            print(f"  decode shape with {sp} splits: {t:.5f} ms "
                  f"({bound / t:.3f} of the bound)")
    row = {"max_abs_err": max(worst.values()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms}
    for rg_b in (8, 1):
        rg_turns(rng, sms, rg_b)
    # qwen2-moe-a2.7b's shape (16 KV heads, G 1, D 128) and the
    # cross-attention families' four
    shape_turns(rng, sms, decode_s,
                [("qwen2-moe self shape", 16, 1, 128, decode_s, None)]
                + _cross_shapes(rng, decode_s))
    q, k, v, lens_l = long_in
    splits_l = num_splits(32, hkv, long_s, rows, sms)
    bound_l, by_l, byts_l = _attn_bound(q, k, lens_l)
    for sp in (1, 2, 4):
        t = host_ms(lambda sp=sp: decode_attention(q, k, v, lens_l,
                                                   splits=sp), iters=10)
        print(f"  long context with {sp} splits: {t:.5f} ms "
              f"({bound_l / t:.3f} of the bound)")
    ms_l = host_ms(lambda: decode_attention(q, k, v, lens_l), iters=10)
    plain_l = host_ms(lambda: decode_attention_ref(q, k, v, lens_l), iters=3,
                      warmup=1)
    lib_l = host_ms(_sdpa(q, k, v, lens_l), iters=3, warmup=1)
    print(f"decode_attention long context B=32 S={long_s} Hkv={hkv} "
          f"Hq={hkv * g} D={d} bf16 (lengths in [S/2, S]): kernel "
          f"{ms_l:.5f} ms with {splits_l} splits, plain {plain_l:.5f} ms, "
          f"sdpa {lib_l:.5f} ms (events around back-to-back calls); bound "
          f"{bound_l:.5f} ms ({by_l}, {byts_l / 1e9:.3f} GB); kernel at "
          f"{byts_l / ms_l / 1e6:.1f} GB/s, {bound_l / ms_l:.3f} of the "
          f"bound, {lib_l / ms_l:.3f}x sdpa's speed")
    del sets, long_in, q, k, v
    torch.cuda.empty_cache()
    return row


# recurrentgemma-9b's decode attention: one KV head, 16 query heads, D 256,
# a ring of 2048 slots
RG_HKV, RG_G, RG_D, RG_WIN = 1, 16, 256, 2048


def rg_turns(rng, sms, b):
    """Time the kernel at recurrentgemma-9b's decode shape (batch ``b``:
    8 at a 4096-token prompt, 1 at long_500k; full rings: every step of
    such a prompt's decode reads all 2048 slots) in turns beside SDPA
    (``enable_gqa=True``), over four caches in turn, as the 12 attention
    layers of a step read 12 (at batch 8, 4 x 16.8 MB > L2; at batch 1
    the four 2.1 MB rings fit it, as a step's 12 do); the bytes bound
    counts each K/V row once, the kernel's two head tiles read it
    twice."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention, head_tiles, num_splits, tile_rows)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    sets = [_attn_inputs(rng, b, RG_HKV, RG_G, RG_D, RG_WIN, torch.bfloat16,
                         [RG_WIN] * b) for _ in range(4)]
    tiles = head_tiles(RG_G)
    splits = num_splits(b, RG_HKV * tiles, RG_WIN, tile_rows(RG_D, 2, True),
                        sms)
    turns = [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
             cold_ms([_sdpa(*x) for x in sets])]
    turns += [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
              cold_ms([_sdpa(*x) for x in sets])]
    ms, lib_ms = turns[2], turns[3]
    plain_ms = cold_ms([lambda x=x: decode_attention_ref(*x) for x in sets])
    bound, by, byts = _attn_bound(sets[0][0], sets[0][1], sets[0][3])
    print(f"  recurrentgemma decode shape B={b} in turns (kernel, sdpa, "
          "kernel, sdpa): " + ", ".join(f"{t:.5f}" for t in turns) + " ms")
    print(f"decode_attention recurrentgemma decode shape B={b} S={RG_WIN} "
          f"Hkv={RG_HKV} Hq={RG_G} (G {RG_G}, {tiles} head tiles) D={RG_D} "
          f"bf16 (full rings): kernel {ms:.5f} ms with {splits} splits "
          f"({b * RG_HKV * tiles * splits} CTAs on {sms} SMs), plain "
          f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms (device time, graph "
          f"replay over 4 caches); bound {bound:.5f} ms ({by}, "
          f"{byts / 1e6:.1f} MB, each K/V row once; the {tiles} head tiles "
          f"read {tiles * (byts - 4 * b * RG_G * RG_D) / 1e6:.1f} MB of K/V)"
          f"; kernel at {byts / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the "
          f"bound, {lib_ms / ms:.3f}x sdpa's speed")
    for sp in (1, 2, 4, 8):
        if sp != splits:
            t = cold_ms([lambda x=x: decode_attention(*x, splits=sp)
                         for x in sets])
            print(f"  recurrentgemma decode shape B={b} with {sp} splits: "
                  f"{t:.5f} ms ({bound / t:.3f} of the bound)")
    del sets


# the cross-attention families' decode attention (batch 8): seamless-m4t-
# medium's 16 KV heads of D 64 (G 1; 2048 source frames) and
# llama-3.2-vision-11b's 8 KV heads of D 128 (G 4; 4096 image tokens)
SEAMLESS_SRC = 2048
VISION_IMG = 4096


def _cross_shapes(rng, decode_s, b=8):
    """(name, Hkv, G, D, keys, lengths) of the four shapes: the self
    attention over ``decode_s`` keys with ragged lengths (a full row, an
    empty one), the cross attention with every row full."""
    def ragged():
        return [decode_s] + list(rng.integers(1, decode_s + 1, b - 2)) + [0]
    return [("seamless self shape", 16, 1, 64, decode_s, ragged()),
            ("seamless cross shape", 16, 1, 64, SEAMLESS_SRC,
             [SEAMLESS_SRC] * b),
            ("vision self shape", 8, 4, 128, decode_s, ragged()),
            ("vision cross shape", 8, 4, 128, VISION_IMG, [VISION_IMG] * b)]


def shape_turns(rng, sms, decode_s, shapes):
    """Time the kernel at ``shapes`` (``_cross_shapes``' tuples: the
    cross-attention families' four, qwen2-moe-a2.7b's self shape) in
    turns beside SDPA (``enable_gqa=True``), each over four caches in
    turn (a decode step reads one a layer), the self shapes at mid-decode
    lengths (every row ``decode_s - 16`` keys), the cross shapes full;
    with the bytes bound, the split count the rule picks, GB/s and the
    share of the bound."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention, head_tiles, num_splits, tile_rows)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b = 8
    for name, hkv, g, d, keys, _ in shapes:
        n = decode_s - 16 if "self" in name else keys
        sets = [_attn_inputs(rng, b, hkv, g, d, keys, torch.bfloat16,
                             [n] * b) for _ in range(4)]
        splits = num_splits(b, hkv * head_tiles(g), keys,
                            tile_rows(d, 2, True), sms)
        turns = [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
                 cold_ms([_sdpa(*x) for x in sets])]
        turns += [cold_ms([lambda x=x: decode_attention(*x) for x in sets]),
                  cold_ms([_sdpa(*x) for x in sets])]
        ms, lib_ms = turns[2], turns[3]
        plain_ms = cold_ms([lambda x=x: decode_attention_ref(*x)
                            for x in sets])
        bound, by, byts = _attn_bound(sets[0][0], sets[0][1], sets[0][3])
        print(f"  {name} in turns (kernel, sdpa, kernel, sdpa): "
              + ", ".join(f"{t:.5f}" for t in turns) + " ms")
        print(f"decode_attention {name} B={b} S={keys} Hkv={hkv} "
              f"Hq={hkv * g} D={d} bf16 (lengths {n}): kernel {ms:.5f} ms "
              f"with {splits} splits ({b * hkv * head_tiles(g) * splits} "
              f"CTAs on {sms} SMs), plain {plain_ms:.5f} ms, sdpa "
              f"{lib_ms:.5f} ms (device time, graph replay over 4 caches); "
              f"bound {bound:.5f} ms ({by}, {byts / 1e6:.1f} MB); kernel at "
              f"{byts / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bound, "
              f"{lib_ms / ms:.3f}x sdpa's speed")
        del sets


# -- phase 6 ----------------------------------------------------------------

def teacher_forced(eng, prompt, forced, backend, extra=None):
    """Logits [B, n, V] of a prefill and n - 1 decode steps fed the
    tokens ``forced`` [B, n] (each step's input is the previous column),
    decode loop under sync-debug "error"; ``extra``: the batch's
    ``src_embeds`` / ``image_embeds``."""
    from repro_torch._device import no_host_sync
    from repro_torch.models import api

    b, s = prompt.shape
    n = forced.shape[1]
    cache, logits = api.prefill(eng.params, eng.cfg,
                                {"tokens": prompt, **(extra or {})})
    cache = api.grow_cache(eng.cfg, cache, b, s, s + n,
                           src_len=_src_len(extra))
    out = [logits]
    with no_host_sync(torch.device("cuda")):
        for i in range(n - 1):
            cache, logits = api.decode_step(eng.params, eng.cfg, cache,
                                            forced[:, i],
                                            attn_backend=backend)
            out.append(logits)
    return torch.stack(out, dim=1)


def compare_backends(eng, prompt, ref_tokens, what, extra=None):
    """The kernel's decode teacher-forced on the "ref" tokens, against
    "ref": (max |diff|, max |diff| / max |logit|, greedy agreement)."""
    lr = teacher_forced(eng, prompt, ref_tokens, "ref", extra)
    lc = teacher_forced(eng, prompt, ref_tokens, "cuda", extra)
    require(bool(torch.isfinite(lc).all()), f"{what}: non-finite logits")
    diff = float((lc - lr).abs().max())
    rel = diff / float(lr.abs().max())
    agree = float((lc.argmax(-1) == lr.argmax(-1)).float().mean())
    print(f"{what}: teacher-forced logits, kernel vs ref over "
          f"{lc.shape[1]} calls: max|diff| {diff:.6g} = {rel:.3g} of the "
          f"largest logit; greedy tokens agree {agree:.4f}")
    return diff, rel, agree


def profile_decode(eng, prompt, steps, what, bound_ms=WEIGHT_READ_MS,
                   attn_layers=None, extra=None):
    """``steps`` steps of the engine's decode loop under torch.profiler,
    replayed from the prompt's position after a generate (graph replays
    on a graph engine, the step body op by op on an eager one): ms a
    step, device busy time, idle share (under the profiler, and against
    the same steps timed just before without it), launch calls a step,
    top kernels.  On a graph engine the busy time is also read with CUDA
    events around back-to-back replays, as a cross-check; the profile
    must hold as many of the port's kernels as the counters count, and
    ``attn_layers`` (default: every layer) decode attention launches a
    step; ``extra``: the batch's ``src_embeds`` / ``image_embeds``.
    Returns (ms a step, busy ms a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    b, s = prompt.shape
    require(steps < eng.scfg.max_new_tokens, "more steps than the cache")
    eng.generate({"tokens": prompt, **(extra or {})})
    key = (b, s, _src_len(extra))
    bufs, graph = eng._decode_bufs[key], eng._graphs.get(key)
    body = eng._decode_body(s)

    def loop():
        bufs["cache"]["pos"].fill_(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            if graph is not None:
                graph.replay()
            else:
                with record_function(STEP_SPAN):
                    body(bufs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sec_plain = loop()
    zero_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        sec = loop()
    avgs = prof.key_averages()
    kern = sorted((a for a in avgs if a.device_type == DeviceType.CUDA
                   and a.key != STEP_SPAN),    # the span's device mirror
                  key=_dev_us, reverse=True)
    if attn_layers is None:
        attn_layers = eng.cfg.num_layers
    seen, kept, lost = steps_match_counts(
        prof, step_units(prof, graph is not None), steps, f"decode ({what})")
    require(seen["decode_attention"] == attn_layers,
            f"decode ({what}): {seen['decode_attention']} attention "
            "kernels a step")
    held = (f"port kernels a step {seen} == the counters', in {kept} of "
            f"{steps} steps ({lost} records lost by the profiler in the "
            "others)")
    busy = sum(_dev_us(a) for a in kern) / 1e6
    n_launch, n_copy = _launches(avgs)
    note = ""
    if graph is not None:
        require(n_launch / steps <= 3, f"decode ({what}): {n_launch} launch "
                f"calls for {steps} steps")
        bufs["cache"]["pos"].fill_(s)
        ev = steps * graph_device_s(graph.graph, steps)
        note = f" (CUDA events around the step graph: {ev:.4f} s)"
    print(f"profile (decode, {what}, {steps} steps): {sec:.4f} s under the "
          f"profiler = {sec / steps * 1e3:.3f} ms a step, device busy "
          f"{busy:.4f} s = {busy / steps * 1e3:.3f} ms a step{note}, idle "
          f"share {1 - busy / sec:.3f} (against {sec_plain / steps * 1e3:.3f}"
          f" ms a step without the profiler: {1 - busy / sec_plain:.3f}); "
          f"{n_launch} launch calls = "
          f"{n_launch / steps:.1f} per step, {n_copy} memcpy calls; "
          f"{held}; bound {bound_ms} ms a step")
    for a in kern[:10] + _port_kernels(kern[10:]):
        print(f"  device {_dev_us(a) / 1e3:9.3f} ms  x{a.count:6d}  "
              f"{a.key[:90]}")
    return sec / steps * 1e3, busy / steps * 1e3


def phase_lm(args):
    """Full-width llama3.2-1b served on the card; returns the decode
    attention launches of the main path's generate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.layers import matmul_f32
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("llama3.2-1b")
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    t0 = time.perf_counter()
    params, _ = api.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    print(f"model: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} Dh={cfg.head_dim} "
          f"ff={cfg.d_ff} V={cfg.vocab_size}, {n_params} bf16 parameters "
          f"({sum(v.numel() * v.element_size() for v in params.values()) / 1e9:.3f}"
          f" GB) drawn from seed {args.seed} in {t_init:.1f} s")
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                 attn_backend="cuda"),
                        device="cuda")
    # the float32 logits head on the card (a bfloat16 GEMM with float32
    # output) against float32 operands
    x = torch.randn(b, cfg.d_model, device="cuda").to(torch.bfloat16)
    t = params["embed/table"]
    head_err = float((matmul_f32(x, t.t()) - x.float() @ t.float().t())
                     .abs().max())
    print(f"logits head, bf16 GEMM with float32 output vs float32 operands: "
          f"max|diff| {head_err:.3g}")
    require(head_err < 1e-4, f"matmul_f32 off by {head_err}")

    # warm-up (cuBLAS, allocator; the graph engine captures its decode
    # step for this shape), then the main path with counts at 0
    eng_eager = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, attn_backend="cuda", step_backend="eager"),
        device="cuda")
    for e in (eng, eng_eager):
        e.generate({"tokens": prompt[:, :64]})
    torch.cuda.reset_peak_memory_stats()
    cap = eng.generate({"tokens": prompt})["capture_s"]
    peak_cap = torch.cuda.max_memory_allocated() / 1e9
    g = eng._graphs[(b, s, None)]
    print(f"capture (decode step, batch {b}, prompt {s}): {cap:.4f} s "
          "(warm-up on the step's own buffers, a copy of pos, + capture), "
          f"outside every timed loop; peak memory of that generate, the "
          f"capture included: {peak_cap:.2f} GB; the address check before "
          f"a replay takes {stale_check_ms(g):.5f} ms of host time "
          f"({len(g._held)} tensors)")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = eng.generate({"tokens": prompt})
    launches = read_counts()
    steps = n_new - 1
    require(launches == {"fused_gate": 0, "fused_gate_prng": 0,
                         "threefry_draw": 0, "int8_gemm": 0,
                         "decode_attention": cfg.num_layers * steps},
            f"generate launches {launches}, want decode_attention = "
            f"{cfg.num_layers} layers x {steps} steps")
    require(out["capture_s"] == 0.0, "the graph was captured again")
    toks = out["tokens"]
    require(toks.shape == (b, n_new) and toks.dtype == torch.int32,
            f"tokens {tuple(toks.shape)} {toks.dtype}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"generate (attn cuda, graph): batch {b}, prompt {s}, {n_new} new "
          f"tokens: prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_s']:.4f} s for {steps} steps = "
          f"{out['decode_s'] / steps * 1e3:.3f} ms a step, "
          f"{out['decode_tok_per_s']:.1f} tok/s; decode_attention launches "
          f"{launches['decode_attention']} = {cfg.num_layers} layers x "
          f"{steps} steps; peak memory {peak:.2f} GB; decode loop under "
          "sync debug mode 'error'")
    zero_counts()
    out_e = eng_eager.generate({"tokens": prompt})
    require(read_counts() == launches,
            f"eager generate launches {read_counts()} != graph {launches}")
    require(torch.equal(out_e["tokens"], toks),
            "graph decode tokens differ from the eager decode's")
    # timing in turns on the same card: eager, graph, graph, eager
    turns = {}
    for name, e in (("eager", eng_eager), ("graph", eng), ("graph", eng),
                    ("eager", eng_eager)):
        r = e.generate({"tokens": prompt})
        require(torch.equal(r["tokens"], toks), f"{name} tokens moved")
        turns.setdefault(name, []).append(r)
    for name, rs in turns.items():
        print(f"decode ({name}): "
              + ", ".join(f"{r['decode_s'] / steps * 1e3:.3f} ms a step = "
                          f"{r['decode_tok_per_s']:.1f} tok/s" for r in rs)
              + f" (in turns: eager, graph, graph, eager; weight-read bound "
              f"{WEIGHT_READ_MS} ms a step); greedy tokens graph == eager")
    eng_ref = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                     attn_backend="ref"),
                            device="cuda")
    zero_counts()
    out_ref = eng_ref.generate({"tokens": prompt})
    require(read_counts()["decode_attention"] == 0,
            "the ref backend launched the kernel")
    agree = float((out_ref["tokens"] == toks).float().mean())
    print(f"generate (attn ref, graph): decode {out_ref['decode_s']:.4f} s = "
          f"{out_ref['decode_tok_per_s']:.1f} tok/s; free-running greedy "
          f"tokens equal to the kernel run's: {agree:.4f}")
    del eng_ref
    compare_backends(eng, prompt, out_ref["tokens"], "bf16")
    profile_decode(eng, prompt, 16, "graph")
    profile_decode(eng_eager, prompt, 16, "eager")
    del eng_eager

    # int8 weights (the FENIX Model Engine scheme on the LM)
    eng8 = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                  quant="int8"),
                         device="cuda")
    out8 = eng8.generate({"tokens": prompt})
    require(out8["tokens"].shape == (b, n_new), "int8 generate shape")
    agree8 = float((out8["tokens"] == toks).float().mean())
    print(f"generate (int8 weights): prefill {out8['prefill_s']:.4f} s, "
          f"decode {out8['decode_tok_per_s']:.1f} tok/s; tokens equal to the "
          f"bf16 run's: {agree8:.4f}")
    del eng8

    # gated serving: the FENIX admission gate in front of the engine
    gated = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=8, gate_backend_rate=100.0), device="cuda")
    arrivals = [{"stream": i % 3, "t_us": i * 400_000,
                 "batch": {"tokens": prompt[i % b:i % b + 1, :256]}}
                for i in range(12)]
    t0 = time.perf_counter()
    res = gated.serve_requests(arrivals)
    require(res["admitted"] + res["denied"] == 12 and res["admitted"] >= 1,
            f"serve_requests {res['admitted']} / {res['denied']}")
    captures = sum(r["capture_s"] > 0 for r in res["results"])
    require(captures == 1, f"serve_requests captured {captures} graphs for "
            "one shape")
    print(f"serve_requests: {res['admitted']} admitted, {res['denied']} "
          f"denied of 12 arrivals by ServeGate in "
          f"{time.perf_counter() - t0:.2f} s; one decode graph captured, "
          "replayed for every admitted request")
    del eng, gated, params
    torch.cuda.empty_cache()

    # a float32 copy of the model: the kernel must match the einsum path
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params32, _ = api.init_params(cfg32, seed=args.seed, device="cuda")
    eng32 = ServingEngine(cfg32, params32, ServeConfig(
        max_new_tokens=n_new, attn_backend="ref"), device="cuda")
    ref32 = eng32.generate({"tokens": prompt})["tokens"]
    _, rel32, _ = compare_backends(eng32, prompt, ref32, "float32")
    require(rel32 <= 1e-3, f"float32 logits off by {rel32} of the largest")
    del eng32, params32
    torch.cuda.empty_cache()

    # a small input against the CPU: the reduced model, float32
    reduced_card_vs_cpu(cfg.name, prompt[:2], args.seed, 16)
    return launches["decode_attention"]


# -- phase 6b ---------------------------------------------------------------

MOE_LAYERS = 4         # the depth served: a sixth of the 24 (the init of
#                        the full depth's 14.31 B parameters took 94 s of the
#                        phase's 139; the widths are the published ones)
MOE_CUT_LAYERS = 4     # depth of the float32 copy (57 GB at full depth)


def _decode_bound(cfg, params, b, smax, routed=None, src_len=None):
    """(ms, GB of weights, GB of cache traffic) one decode step needs at
    3.35 TB/s: every weight the step reads once (an untied embedding
    table gives the B rows gathered; a tied one is the logits head's
    operand, read whole; an encoder's weights are not read), the K/V
    cache (entries with a ``kv_seq`` axis: the hybrid's rings, the cross
    K/V of ``src_len`` rows included) read once, and the recurrent states
    and conv tails (no ``kv_seq`` axis) read and written.  ``routed``:
    the experts the step routes to, summed over its layers; only their
    weights count.  With ``None`` every expert counts: the read volume of
    the port's capacity dispatch, which runs each expert every step, not
    the step's bound."""
    from repro_torch.models import api

    w = 0.0
    for k, v in params.items():
        if k.startswith(("enc/", "ln_enc_f/")):
            continue
        byts = v.numel() * v.element_size()
        if k.startswith("embed/") and not cfg.tie_embeddings:
            byts = b * cfg.d_model * v.element_size() if k.endswith(
                "/table") else 0
        if routed is not None and "/experts/" in k \
                and not k.endswith("_scale"):
            byts *= routed / (v.shape[0] * v.shape[1])   # [L, e, ...]
        w += byts
    cache = 0.0
    for shape, dt, axes in api.cache_specs(cfg, b, smax,
                                           src_len=src_len).values():
        n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        cache += n if "kv_seq" in axes else 2 * n
    return (w + cache) / HBM_BYTES_PER_S * 1e3, w / 1e9, cache / 1e9


def _routed_experts(eng, prompt):
    """A generate on the eager engine ``eng`` whose decode steps record
    the experts they route to (``layers._top_k`` wrapped; the recorded
    indices are counted after the loop, so it stays free of host syncs).
    Returns (the generate's output, the distinct experts routed a step
    summed over the MoE layers, the distinct experts of each MoE layer's
    step)."""
    from repro_torch.models import layers

    top_k, seen = layers._top_k, []
    b = prompt.shape[0]

    def record(probs, k):
        val, idx = top_k(probs, k)
        if idx.shape[0] == b:           # a decode step's b tokens
            seen.append(idx)
        return val, idx

    layers._top_k = record
    try:
        out = eng.generate({"tokens": prompt})
    finally:
        layers._top_k = top_k
    per = [int(torch.unique(i).numel()) for i in seen]
    cfg = eng.cfg
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    return out, sum(per) / max(len(per) // n_moe, 1), per


def phase_moe(args):
    """6b. Full-width qwen2-moe-a2.7b served on the card; returns the
    decode attention launches of the main path's generate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              num_layers=MOE_LAYERS)
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = api.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    gb = sum(v.numel() * v.element_size() for v in params.values()) / 1e9
    m = cfg.moe
    print(f"model: {cfg.name} L={cfg.num_layers} (of 24: cut in depth) "
          f"d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} Dh={cfg.head_dim} experts "
          f"{m.num_experts} top-{m.top_k} (ff {m.expert_d_ff}) + "
          f"{m.num_shared_experts} shared (ff {m.shared_d_ff}, gated) "
          f"V={cfg.vocab_size}: {n_params} parameters ({gb:.3f} GB: bf16, "
          f"the router float32) drawn from seed {args.seed} in {t_init:.1f} "
          "s (the reference's numpy draws, each parameter in 1 GiB "
          "float64 chunks, 8 parameters at a time in a thread pool, each "
          "chunk cast on the host and copied to the card)")
    require(n_params == sum(math.prod(v.shape) for v in params.values()),
            "parameter count")
    dense_ms, w_gb, kv_gb = _decode_bound(cfg, params, b, s + n_new)
    cap = max(1, int(m.capacity_factor * b * m.top_k / m.num_experts))
    print(f"decode step read volume of the port's dispatch: {w_gb:.3f} GB "
          f"of weights (every expert: capacity {cap} a step at batch {b}, "
          f"and each expert runs) + {kv_gb:.3f} GB of K/V cache at 3.35 "
          f"TB/s = {dense_ms:.3f} ms (not the step's bound: that counts "
          "only the experts routed to, below)")
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                 attn_backend="cuda"),
                        device="cuda")
    eng_eager = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, attn_backend="cuda", step_backend="eager"),
        device="cuda")
    for e in (eng, eng_eager):
        e.generate({"tokens": prompt[:, :64]})
    cap_s = eng.generate({"tokens": prompt})["capture_s"]
    zero_counts()
    out = eng.generate({"tokens": prompt})
    launches = read_counts()
    steps = n_new - 1
    require(launches == {"fused_gate": 0, "fused_gate_prng": 0,
                         "threefry_draw": 0, "int8_gemm": 0,
                         "decode_attention": cfg.num_layers * steps},
            f"MoE generate launches {launches}, want decode_attention = "
            f"{cfg.num_layers} layers x {steps} steps")
    require(out["capture_s"] == 0.0, "the MoE graph was captured again")
    toks = out["tokens"]
    require(toks.shape == (b, n_new) and toks.dtype == torch.int32
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"MoE tokens {tuple(toks.shape)} {toks.dtype}")
    print(f"generate ({cfg.name}, attn cuda, graph): batch {b}, prompt {s},"
          f" {n_new} new tokens: prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_s']:.4f} s for {steps} steps = "
          f"{out['decode_s'] / steps * 1e3:.3f} ms a step, "
          f"{out['decode_tok_per_s']:.1f} tok/s; capture {cap_s:.4f} s; "
          f"decode_attention launches {launches['decode_attention']} = "
          f"{cfg.num_layers} layers x {steps} steps; decode loop under "
          "sync debug mode 'error'")
    zero_counts()
    out_e, routed, per = _routed_experts(eng_eager, prompt)
    require(read_counts() == launches,
            f"MoE eager launches {read_counts()} != graph {launches}")
    require(torch.equal(out_e["tokens"], toks),
            "MoE graph decode tokens differ from the eager decode's")
    require(len(per) == cfg.num_layers * steps,
            f"{len(per)} routings recorded for {steps} decode steps")
    bound_ms, w_r, _ = _decode_bound(cfg, params, b, s + n_new, routed)
    print(f"decode step bound: the experts each step routes to, "
          f"{routed / cfg.num_layers:.3f} of {m.num_experts} a layer on "
          f"average ({min(per)}-{max(per)}; at most min(e, B k) = "
          f"{min(m.num_experts, b * m.top_k)}), measured on the eager "
          f"generate: {w_r:.3f} GB of weights + {kv_gb:.3f} GB of K/V "
          f"cache at 3.35 TB/s = {bound_ms:.3f} ms; graph decode "
          f"{out['decode_s'] / steps * 1e3 / bound_ms:.2f}x the bound, "
          f"{out['decode_s'] / steps * 1e3 / dense_ms:.2f}x the dispatch's "
          f"{dense_ms:.3f} ms read volume")
    turns = {}
    for name, e in (("eager", eng_eager), ("graph", eng), ("graph", eng),
                    ("eager", eng_eager)):
        r = e.generate({"tokens": prompt})
        require(torch.equal(r["tokens"], toks), f"MoE {name} tokens moved")
        turns.setdefault(name, []).append(r)
    for name, rs in turns.items():
        print(f"decode ({cfg.name}, {name}): "
              + ", ".join(f"{r['decode_s'] / steps * 1e3:.3f} ms a step = "
                          f"{r['decode_tok_per_s']:.1f} tok/s" for r in rs)
              + f" (in turns: eager, graph, graph, eager; bound "
              f"{bound_ms:.3f} ms a step, read volume {dense_ms:.3f}); "
              "prefill "
              + ", ".join(f"{r['prefill_s']:.4f}" for r in rs)
              + " s; greedy tokens graph == eager")
    del eng_eager
    profile_decode(eng, prompt, 16, f"{cfg.name} graph", round(bound_ms, 3))
    print(f"peak memory of phase 6b so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (weights, two "
          "engines' caches, prefill)")

    # int8 weights (the FENIX Model Engine scheme on the LM)
    eng8 = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                  quant="int8"),
                         device="cuda")
    eng8.generate({"tokens": prompt[:, :64]})
    out8 = eng8.generate({"tokens": prompt})
    require(out8["tokens"].shape == (b, n_new), "MoE int8 generate shape")
    agree8 = float((out8["tokens"] == toks).float().mean())
    bound8, w8, _ = _decode_bound(cfg, eng8.params, b, s + n_new, routed)
    dense8, _, _ = _decode_bound(cfg, eng8.params, b, s + n_new)
    print(f"generate ({cfg.name}, int8 weights, graph): prefill "
          f"{out8['prefill_s']:.4f} s, decode "
          f"{out8['decode_s'] / steps * 1e3:.3f} ms a step (bound "
          f"{bound8:.3f} ms: {w8:.3f} GB of weights, the bf16 run's routed "
          f"experts, + the cache; read volume {dense8:.3f} ms) = "
          f"{out8['decode_tok_per_s']:.1f} tok/s (each step dequantizes "
          "every expert's weights to bf16); tokens equal to the bf16 "
          f"run's: {agree8:.4f}")
    del eng8, eng
    print(f"peak memory of phase 6b: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # float32 logits, kernel against the einsum path, on a copy cut in
    # depth (a float32 copy at full depth, 57 GB, does not fit beside the
    # bf16 model): the first layers of the same weights
    cut = MOE_CUT_LAYERS
    cfg32 = dataclasses.replace(cfg, num_layers=cut, param_dtype="float32",
                                activation_dtype="float32")
    p32 = {k: (v[:cut] if k.startswith("layers/") else v).float()
           for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    eng32 = ServingEngine(cfg32, p32, ServeConfig(
        max_new_tokens=n_new, attn_backend="ref"), device="cuda")
    ref32 = eng32.generate({"tokens": prompt})["tokens"]
    _, rel32, _ = compare_backends(eng32, prompt, ref32,
                                   f"{cfg.name} float32, {cut} layers")
    require(rel32 <= 1e-3, f"MoE float32 logits off by {rel32}")
    del eng32, p32
    torch.cuda.empty_cache()

    # the reduced model on the card against the CPU, float32
    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 16)
    return launches["decode_attention"]


# -- phases 6c and 6d: the sub-quadratic families ---------------------------

RG_CUT_SUPERBLOCKS = 2  # depth of recurrentgemma's float32 copy: 6 layers


def _init_model(cfg, seed):
    """The full-width model's bf16 weights drawn on the card, with the
    seconds and a printed summary."""
    from repro_torch.models import api

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = api.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    gb = sum(v.numel() * v.element_size() for v in params.values()) / 1e9
    print(f"model: {cfg.name} ({cfg.family}) L={cfg.num_layers} "
          f"d={cfg.d_model} V={cfg.vocab_size}: {n_params} parameters "
          f"({gb:.3f} GB, bf16 but the float32 norms, decays and gates) "
          f"drawn from seed {seed} in {t_init:.1f} s (8 parameters at a "
          "time in a thread pool)")
    return params


def _src_len(extra):
    """The source length of a batch's ``src_embeds`` / ``image_embeds``
    (None without): the third part of the engine's shape key."""
    return None if not extra else next(iter(extra.values())).shape[1]


def serve_family(cfg, params, prompt, n_new, attn_layers, bound_ms,
                       extra=None):
    """The main path of a family served whole: ``generate`` on the decode
    graph with the kernel counts at 0 just before it (``attn_layers``
    decode attention launches a step, nothing else of the port's), graph
    tokens and counts == the eager step's, ms a step of both in turns
    beside the bound, and the graph's decode loop profiled.  ``extra``:
    the batch's ``src_embeds`` / ``image_embeds`` (the cross-attention
    families).  Returns (the generate's output, its launches, the graph
    engine)."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    b, s = prompt.shape
    extra = extra or {}
    batch = {"tokens": prompt, **extra}
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                 attn_backend="cuda"),
                        device="cuda")
    eng_eager = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, attn_backend="cuda", step_backend="eager"),
        device="cuda")
    for e in (eng, eng_eager):
        e.generate({"tokens": prompt[:, :64], **extra})
    cap = eng.generate(batch)["capture_s"]
    zero_counts()
    out = eng.generate(batch)
    launches = read_counts()
    steps = n_new - 1
    require(launches == {"fused_gate": 0, "fused_gate_prng": 0,
                         "threefry_draw": 0, "int8_gemm": 0,
                         "decode_attention": attn_layers * steps},
            f"{cfg.name} generate launches {launches}, want "
            f"decode_attention = {attn_layers} a step x {steps} steps")
    require(out["capture_s"] == 0.0, f"{cfg.name}: captured again")
    toks = out["tokens"]
    require(toks.shape == (b, n_new) and toks.dtype == torch.int32
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{cfg.name} tokens {tuple(toks.shape)} {toks.dtype}")
    print(f"generate ({cfg.name}, graph): batch {b}, prompt {s}, {n_new} "
          f"new tokens: prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_s']:.4f} s for {steps} steps = "
          f"{out['decode_s'] / steps * 1e3:.3f} ms a step, "
          f"{out['decode_tok_per_s']:.1f} tok/s; capture {cap:.4f} s "
          "(the warm-up on copies of the cache entries without a kv_seq "
          "axis: pos, recurrent states); "
          f"decode_attention launches {launches['decode_attention']} = "
          f"{attn_layers} a step x {steps} steps; decode loop "
          "under sync debug mode 'error'")
    zero_counts()
    out_e = eng_eager.generate(batch)
    require(read_counts() == launches,
            f"{cfg.name} eager launches {read_counts()} != graph {launches}")
    require(torch.equal(out_e["tokens"], toks),
            f"{cfg.name}: graph decode tokens differ from the eager decode's")
    turns = {}
    for name, e in (("eager", eng_eager), ("graph", eng), ("graph", eng),
                    ("eager", eng_eager)):
        r = e.generate(batch)
        require(torch.equal(r["tokens"], toks), f"{cfg.name} {name} tokens "
                "moved")
        turns.setdefault(name, []).append(r)
    for name, rs in turns.items():
        print(f"decode ({cfg.name}, {name}): "
              + ", ".join(f"{r['decode_s'] / steps * 1e3:.3f} ms a step = "
                          f"{r['decode_tok_per_s']:.1f} tok/s" for r in rs)
              + f" (in turns: eager, graph, graph, eager; bound "
              f"{bound_ms:.3f} ms a step); prefill "
              + ", ".join(f"{r['prefill_s']:.4f}" for r in rs)
              + " s; greedy tokens graph == eager")
    del eng_eager
    profile_decode(eng, prompt, 16, f"{cfg.name} graph", round(bound_ms, 3),
                   attn_layers=attn_layers, extra=extra)
    return out, launches, eng


def decode_vs_prefill(eng, prompt, forced, what):
    """The decode path against the prefill path on the same tokens, in
    float32: the logits of the last of n - 1 decode steps teacher-forced
    on ``forced`` [B, n] after a prefill of ``prompt``, against a prefill
    of the prompt followed by ``forced[:, :-1]`` (its last position): the
    recurrences (and the ring) against the chunked SSD / the associative
    scan (and the windowed band attention).  Returns max |diff| over the
    largest logit."""
    from repro_torch.models import api

    lc = teacher_forced(eng, prompt, forced, "cuda")[:, -1]
    full = torch.cat([prompt, forced[:, :-1]], dim=1)
    _, lp = api.prefill(eng.params, eng.cfg, {"tokens": full})
    require(bool(torch.isfinite(lc).all() and torch.isfinite(lp).all()),
            f"{what}: non-finite logits")
    rel = float((lc - lp).abs().max()) / float(lp.abs().max())
    print(f"{what}: decode after a {prompt.shape[1]}-token prefill and "
          f"{forced.shape[1] - 1} teacher-forced steps against one prefill "
          f"of all {full.shape[1]} tokens, last logits: max|diff| = "
          f"{rel:.3g} of the largest logit")
    return rel


def int8_generate(cfg, params, prompt, n_new, toks, bound_ms, extra=None):
    """An int8-weight generate (the FENIX Model Engine scheme on the LM;
    ``conv/w`` enters the recurrent blocks raw, as in the reference)."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    extra = extra or {}
    eng8 = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                  quant="int8"),
                         device="cuda")
    eng8.generate({"tokens": prompt[:, :64], **extra})
    out8 = eng8.generate({"tokens": prompt, **extra})
    require(out8["tokens"].shape == toks.shape, f"{cfg.name} int8 shape")
    agree8 = float((out8["tokens"] == toks).float().mean())
    print(f"generate ({cfg.name}, int8 weights, graph): prefill "
          f"{out8['prefill_s']:.4f} s, decode "
          f"{out8['decode_s'] / (n_new - 1) * 1e3:.3f} ms a step = "
          f"{out8['decode_tok_per_s']:.1f} tok/s (bf16 bound {bound_ms:.3f}"
          f" ms); tokens equal to the bf16 run's: {agree8:.4f}")


def reduced_card_vs_cpu(name, prompt, seed, s_small, extra_for=None,
                        **over):
    """The reduced model in float32 (config fields ``over``), 8 new tokens
    after the first ``s_small`` tokens of ``prompt`` (each row): the card
    (the decode graph, the attention kernel) == the CPU (eager, the einsum
    path).  ``extra_for(cfg, params)``: the batch's other inputs for the
    reduced config (CPU tensors), after setting what it must in the
    params (the vision LM's gates)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    small = dataclasses.replace(get_config(name, reduced=True),
                                param_dtype="float32",
                                activation_dtype="float32", **over)
    p_small, _ = api.init_params(small, seed=seed, device="cpu")
    batch = {"tokens": prompt[:, :s_small].cpu() % small.vocab_size}
    if extra_for is not None:
        batch.update(extra_for(small, p_small))
    runs = {dev: ServingEngine(small, p_small, ServeConfig(max_new_tokens=8),
                               device=dev).generate(batch)
            ["tokens"].cpu() for dev in ("cuda", "cpu")}
    require(torch.equal(runs["cuda"], runs["cpu"]),
            f"reduced {name}: card tokens differ from the CPU's")
    print(f"reduced {name} (float32), batch {prompt.shape[0]}, a "
          f"{s_small}-token prompt, 8 new tokens: card (graph, kernel) == "
          "CPU (eager, einsum path)")


def phase_ssm(args):
    """6c. Full-width mamba2-370m served on the card, then long_500k;
    returns the decode attention launches of its main path (0: the family
    has no attention)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("mamba2-370m")
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    params = _init_model(cfg, args.seed)
    bound_ms, w_gb, c_gb = _decode_bound(cfg, params, b, s + n_new)
    print(f"decode step bound ({cfg.name}, batch {b}): {w_gb:.3f} GB of "
          f"weights + {c_gb:.3f} GB of state traffic (the float32 SSM "
          f"states and conv tails read and written) at 3.35 TB/s = "
          f"{bound_ms:.3f} ms")
    out, launches, eng = serve_family(cfg, params, prompt, n_new, 0,
                                            bound_ms)
    toks = out["tokens"]
    del eng
    int8_generate(cfg, params, prompt, n_new, toks, bound_ms)
    print(f"peak memory of phase 6c (batch {b}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # float32 at full width: the decode recurrence against the chunked
    # SSD prefill over the same tokens
    p32 = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    eng32 = ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=n_new),
                          device="cuda")
    rel = decode_vs_prefill(eng32, prompt, toks, f"{cfg.name} float32")
    require(rel <= 1e-3, f"{cfg.name} float32 decode off the prefill by "
            f"{rel}")
    del eng32, p32
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 45)
    serve_long_500k(cfg, params, rng, 0, "the state is O(1): the same "
                    "step as at 4096 tokens, batch 1")
    del params
    torch.cuda.empty_cache()
    return launches["decode_attention"]


def serve_long_500k(cfg, params, rng, per_step, note):
    """long_500k: batch 1, a 524288-token prefill (in segments: each
    family's ``PREFILL_*`` budget) and 8 decode steps on the decode
    graph, the kernel counts at 0 just before and read just after
    (``per_step`` decode attention launches a step, nothing else of the
    port's); its seconds, peak memory, position, the recurrent states
    finite.  Returns the decode attention launches."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    shape = SHAPES["long_500k"]
    b, s = shape.global_batch, shape.seq_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompt_l = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                .astype(np.int32)).cuda()
    eng_l = ServingEngine(cfg, params, ServeConfig(max_new_tokens=9,
                                                   attn_backend="cuda"),
                          device="cuda")
    zero_counts()
    out_l = eng_l.generate({"tokens": prompt_l})
    launches = read_counts()
    require(launches == {"fused_gate": 0, "fused_gate_prng": 0,
                         "threefry_draw": 0, "int8_gemm": 0,
                         "decode_attention": per_step * 8},
            f"long_500k ({cfg.name}) launches {launches}, want "
            f"decode_attention = {per_step} a step x 8 steps")
    peak_l = torch.cuda.max_memory_allocated() / 1e9
    cache_l = eng_l._decode_bufs[(b, s, None)]["cache"]
    require(int(cache_l["pos"]) == s + 8, "long_500k position")
    for k, (_, _, axes) in api.cache_specs(cfg, b, s + 8).items():
        if k != "pos" and "kv_seq" not in axes:
            require(bool(torch.isfinite(cache_l[k]).all()),
                    f"long_500k ({cfg.name}): non-finite {k}")
    tl = out_l["tokens"]
    require(bool(((tl >= 0) & (tl < cfg.vocab_size)).all()),
            "long_500k token outside the vocabulary")
    print(f"long_500k ({cfg.name}): batch {b}, a {s}-token prefill in "
          f"{out_l['prefill_s']:.3f} s ({s / out_l['prefill_s']:.0f} "
          f"tok/s), capture {out_l['capture_s']:.3f} s, 8 decode steps in "
          f"{out_l['decode_s'] * 1e3:.3f} ms = "
          f"{out_l['decode_s'] / 8 * 1e3:.3f} ms a step ({note}); "
          f"decode_attention launches {launches['decode_attention']} = "
          f"{per_step} a step x 8 steps; peak memory {peak_l:.2f} GB; the "
          "recurrent states finite after 8 steps")
    del eng_l, cache_l
    torch.cuda.empty_cache()
    return launches["decode_attention"]


def phase_hybrid(args):
    """6d. Full-width recurrentgemma-9b served on the card; returns the
    decode attention launches of its main path's generate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("recurrentgemma-9b")
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    pat = cfg.hybrid.pattern
    attn_layers = sum(pat[i % len(pat)] == "attention"
                      for i in range(cfg.num_layers))
    win = cfg.hybrid.attention_window
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    params = _init_model(cfg, args.seed)
    bound_ms, w_gb, c_gb = _decode_bound(cfg, params, b, s + n_new)
    print(f"decode step bound ({cfg.name}, batch {b}): {w_gb:.3f} GB of "
          f"weights + {c_gb:.3f} GB of cache traffic ({attn_layers} rings "
          f"of {win} K/V slots read; the RG-LRU states and conv tails read "
          f"and written) at 3.35 TB/s = {bound_ms:.3f} ms; decode attention"
          f" at {cfg.num_heads} query heads over {cfg.num_kv_heads} KV head"
          f" (G {cfg.num_heads // cfg.num_kv_heads}), D {cfg.head_dim}")
    out, launches, eng = serve_family(cfg, params, prompt, n_new,
                                            attn_layers, bound_ms)
    toks = out["tokens"]
    # a prompt that is not a multiple of the window (the prefill's roll
    # is not the identity): graph == eager there too
    s2 = 2500
    eng_eager = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, attn_backend="cuda", step_backend="eager"),
        device="cuda")
    r2 = {name: e.generate({"tokens": prompt[:, :s2]})
          for name, e in (("graph", eng), ("eager", eng_eager))}
    require(torch.equal(r2["graph"]["tokens"], r2["eager"]["tokens"]),
            f"{cfg.name}, a {s2}-token prompt: graph tokens differ from "
            "the eager decode's")
    print(f"generate ({cfg.name}, a {s2}-token prompt: {s2} % {win} = "
          f"{s2 % win}): graph == eager tokens; decode "
          f"{r2['graph']['decode_s'] / (n_new - 1) * 1e3:.3f} ms a step "
          f"(graph), {r2['eager']['decode_s'] / (n_new - 1) * 1e3:.3f} "
          "(eager)")
    del eng_eager
    eng_ref = ServingEngine(cfg, params, ServeConfig(max_new_tokens=n_new,
                                                     attn_backend="ref"),
                            device="cuda")
    zero_counts()
    out_ref = eng_ref.generate({"tokens": prompt})
    require(read_counts()["decode_attention"] == 0,
            "the ref backend launched the kernel")
    print(f"generate ({cfg.name}, attn ref, graph): decode "
          f"{out_ref['decode_s'] / (n_new - 1) * 1e3:.3f} ms a step; "
          "bf16 free-running greedy tokens equal to the kernel run's: "
          f"{float((out_ref['tokens'] == toks).float().mean()):.4f} (the "
          "kernel keeps p in float32, the einsum path casts it to bf16; "
          "equal tokens are required in float32, below)")
    del eng_ref, eng
    int8_generate(cfg, params, prompt, n_new, toks, bound_ms)
    print(f"peak memory of phase 6d: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (weights, "
          "engines' caches, prefill, the int8 copy)")
    long_attn = serve_long_500k(
        cfg, params, rng, attn_layers,
        f"{attn_layers} attention layers over full {win}-slot rings; the "
        "prefill in segments of recurrentgemma.PREFILL_TOKENS")

    # float32 on a cut of whole (r, r, a) superblocks of the same weights
    cut = RG_CUT_SUPERBLOCKS
    cfg32 = dataclasses.replace(cfg, num_layers=cut * len(pat),
                                param_dtype="float32",
                                activation_dtype="float32")
    p32 = {k: (v[:cut] if k.startswith("sb/") else v).float()
           for k, v in params.items() if not k.startswith("tail/")}
    del params
    torch.cuda.empty_cache()
    what = f"{cfg.name} float32, {cfg32.num_layers} layers"
    runs = {}
    for backend in ("ref", "cuda"):
        e32 = ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=n_new,
                                                    attn_backend=backend),
                            device="cuda")
        zero_counts()
        runs[backend] = e32.generate({"tokens": prompt})["tokens"]
        require(read_counts()["decode_attention"] ==
                (cut * pat.count("attention") * (n_new - 1)
                 if backend == "cuda" else 0),
                f"{what}: decode attention launches {read_counts()}")
    require(torch.equal(runs["ref"], runs["cuda"]),
            f"{what}: the kernel's greedy tokens differ from the einsum "
            "path's")
    print(f"{what}: greedy tokens attn cuda == attn ref over {n_new} tokens")
    _, rel32, _ = compare_backends(e32, prompt, runs["ref"], what)
    require(rel32 <= 1e-3, f"{what}: logits off by {rel32}")
    rel = decode_vs_prefill(e32, prompt, runs["cuda"], what)
    require(rel <= 1e-3, f"{what}: decode off the prefill by {rel}")
    del e32
    segmented_vs_whole(cfg32, p32, rng, what)
    del p32
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 45)
    return launches["decode_attention"] + long_attn


RG_SEG_CHECK = (16384, 4096)   # (tokens, forced segment) of 6d's check


def segmented_vs_whole(cfg32, p32, rng, what):
    """The hybrid's segmented prefill against its prefill in one piece,
    at a length where both fit: batch 1, a 16384-token prompt, segments
    of 4096 positions forced (``recurrentgemma.PREFILL_TOKENS``): the last
    logits within 1e-3 of the largest (the scan's tree and the
    attention's blocks differ by segment: rounding only) and the greedy
    tokens of 8 decode steps on each cache equal."""
    from repro_torch.models import api
    from repro_torch.models import recurrentgemma as rg
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    n, seg = RG_SEG_CHECK
    toks = torch.from_numpy(rng.integers(0, cfg32.vocab_size, (1, n))
                            .astype(np.int32)).cuda()
    budget, runs = rg.PREFILL_TOKENS, {}
    try:
        for name, tokens in (("whole", n), ("segmented", seg)):
            rg.PREFILL_TOKENS = tokens
            _, logits = api.prefill(p32, cfg32, {"tokens": toks})
            out = ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=9),
                                device="cuda").generate({"tokens": toks})
            runs[name] = logits, out["tokens"]
    finally:
        rg.PREFILL_TOKENS = budget
    (lw, tw), (ls, ts) = runs["whole"], runs["segmented"]
    require(bool(torch.isfinite(ls).all()), f"{what}: non-finite logits")
    rel = float((lw - ls).abs().max()) / float(lw.abs().max())
    require(rel <= 1e-3, f"{what}: the segmented prefill's logits off the "
            f"whole prompt's by {rel}")
    require(torch.equal(tw, ts), f"{what}: the segmented prefill's greedy "
            "tokens differ from the whole prompt's")
    print(f"{what}: a {n}-token prefill in {n // seg} segments of {seg} "
          f"against one piece: last logits max|diff| = {rel:.3g} of the "
          "largest logit; greedy tokens of 8 decode steps equal")


# -- phases 6e and 6f: the cross-attention families ------------------------

VISION_GATE = 0.5       # the vision LM's cross-layer gates while served
VISION_CUT_SUPERBLOCKS = 1  # depth of its float32 copy: 5 layers


def _normals(rng, shape):
    """float32 standard normals from ``rng`` on the card (the stub
    frontends' frame and patch embeddings)."""
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).cuda()


def float32_backends(cfg32, p32, prompt, n_new, extra, per_step, what):
    """On a float32 copy: the greedy tokens of the kernel's decode equal
    the einsum path's, with ``per_step`` kernel launches a step, and the
    kernel's teacher-forced logits within 1e-3 of the largest."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    runs = {}
    for backend in ("ref", "cuda"):
        e32 = ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=n_new,
                                                    attn_backend=backend),
                            device="cuda")
        zero_counts()
        runs[backend] = e32.generate({"tokens": prompt, **extra})["tokens"]
        require(read_counts()["decode_attention"] ==
                (per_step * (n_new - 1) if backend == "cuda" else 0),
                f"{what}: decode attention launches {read_counts()}")
    require(torch.equal(runs["ref"], runs["cuda"]),
            f"{what}: the kernel's greedy tokens differ from the einsum "
            "path's")
    print(f"{what}: greedy tokens attn cuda == attn ref over {n_new} tokens")
    _, rel32, _ = compare_backends(e32, prompt, runs["ref"], what, extra)
    require(rel32 <= 1e-3, f"{what}: logits off by {rel32}")


def phase_encdec(args):
    """6e. Full-width seamless-m4t-medium served on the card; returns the
    decode attention launches of its main path's generate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("seamless-m4t-medium")
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    per_step = 2 * cfg.num_decoder_layers       # self + cross
    rng = np.random.default_rng(args.seed + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    extra = {"src_embeds": _normals(rng, (b, SEAMLESS_SRC, cfg.d_model))}
    params = _init_model(cfg, args.seed)
    bound_ms, w_gb, c_gb = _decode_bound(cfg, params, b, s + n_new,
                                         src_len=SEAMLESS_SRC)
    print(f"decode step bound ({cfg.name}, batch {b}): {w_gb:.3f} GB of "
          f"decoder and head weights + {c_gb:.3f} GB of K/V ({s + n_new} "
          f"self rows and {SEAMLESS_SRC} cross rows a layer, "
          f"{cfg.num_decoder_layers} layers) at 3.35 TB/s = {bound_ms:.3f} "
          f"ms; the encoder runs at prefill only; source {SEAMLESS_SRC} "
          f"frames, prompt {s} tokens")
    out, launches, eng = serve_family(cfg, params, prompt, n_new,
                                            per_step, bound_ms, extra=extra)
    toks = out["tokens"]
    del eng
    # requests with two source lengths on one graph engine: a cache and a
    # graph each, every request's tokens those of a fresh engine
    eng2 = ServingEngine(cfg, params, ServeConfig(max_new_tokens=8),
                         device="cuda")
    arrivals = []
    for i, s_src in enumerate((SEAMLESS_SRC, SEAMLESS_SRC // 2,
                               SEAMLESS_SRC, SEAMLESS_SRC // 2)):
        arrivals.append({"stream": i, "t_us": i * 1000, "batch": {
            "tokens": prompt[2 * i:2 * i + 2, :256],
            "src_embeds": extra["src_embeds"][2 * i:2 * i + 2, :s_src]}})
    res = eng2.serve_requests(arrivals)
    captured = [r["capture_s"] > 0 for r in res["results"]]
    require(res["admitted"] == 4 and captured == [True, True, False, False],
            f"{cfg.name} serve_requests: {res['admitted']} admitted, "
            f"captures {captured}")
    require(sorted(eng2._graphs) == [(2, 256, SEAMLESS_SRC // 2),
                                     (2, 256, SEAMLESS_SRC)],
            f"{cfg.name} serve_requests graphs {sorted(eng2._graphs)}")
    for req, r in zip(arrivals, res["results"]):
        fresh = ServingEngine(cfg, params, ServeConfig(max_new_tokens=8),
                              device="cuda").generate(req["batch"])
        require(torch.equal(fresh["tokens"], r["tokens"]),
                f"{cfg.name}: a served request's tokens differ from a "
                "fresh engine's")
    print(f"serve_requests ({cfg.name}): 4 requests with sources of "
          f"{SEAMLESS_SRC} and {SEAMLESS_SRC // 2} frames in turns: one "
          f"cache and graph each ({sorted(eng2._graphs)}), captured "
          f"{captured}; tokens == fresh engines'")
    del eng2
    int8_generate(cfg, params, prompt, n_new, toks, bound_ms, extra)
    print(f"peak memory of phase 6e: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # float32 at full depth (3.9 GB): kernel == einsum path
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    del params
    float32_backends(cfg32, p32, prompt, n_new, extra, per_step,
                     f"{cfg.name} float32")
    del p32
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 16,
                        extra_for=lambda c, p: {"src_embeds": torch.randn(
                            b, 11, c.d_model, generator=torch.Generator()
                            .manual_seed(args.seed))})
    return launches["decode_attention"]


def _set_gates(params, gate):
    """The params with every cross layer's ``gate_attn`` / ``gate_mlp`` at
    ``gate`` (new tensors; the others shared)."""
    return {k: (torch.full_like(v, gate) if k.endswith(
        ("gate_attn", "gate_mlp")) else v) for k, v in params.items()}


def phase_vlm(args):
    """6f. Full-width llama-3.2-vision-11b served on the card with its
    gates at ``VISION_GATE``; returns the decode attention launches of its
    main path's generate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_config("llama-3.2-vision-11b")
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    rng = np.random.default_rng(args.seed + 3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    extra = {"image_embeds": _normals(rng, (b, cfg.num_image_tokens,
                                            cfg.d_model))}
    drawn = _init_model(cfg, args.seed)
    # at the reference's gates (0) every cross layer is the identity: the
    # image, and the kernel's cross launches, would reach no logit
    params = _set_gates(drawn, VISION_GATE)
    bound_ms, w_gb, c_gb = _decode_bound(cfg, params, b, s + n_new)
    print(f"decode step bound ({cfg.name}, batch {b}): {w_gb:.3f} GB of "
          f"weights (the embedding gather B rows) + {c_gb:.3f} GB of K/V "
          f"({s + n_new} rows in each of the {cfg.num_layers // 5 * 4} self "
          f"layers, {cfg.num_image_tokens} image rows in each of the "
          f"{cfg.num_layers // 5} cross layers) at 3.35 TB/s = "
          f"{bound_ms:.3f} ms; gates at {VISION_GATE}")
    out, launches, eng = serve_family(cfg, params, prompt, n_new,
                                            cfg.num_layers, bound_ms,
                                            extra=extra)
    toks = out["tokens"]
    del eng
    eng0 = ServingEngine(cfg, drawn, ServeConfig(max_new_tokens=n_new),
                         device="cuda")
    toks0 = eng0.generate({"tokens": prompt, **extra})["tokens"]
    same = float((toks0 == toks).float().mean())
    require(same < 1.0, f"{cfg.name}: the gates at {VISION_GATE} give the "
            "tokens of gates 0 (the image reaches no logit)")
    print(f"generate ({cfg.name}) at the reference's gates 0 (every cross "
          f"layer the identity): tokens equal to those at gates "
          f"{VISION_GATE}: {same:.4f}")
    del eng0, drawn
    int8_generate(cfg, params, prompt, n_new, toks, bound_ms, extra)
    print(f"peak memory of phase 6f: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (weights, "
          "engines' caches, prefill, the int8 copy)")

    # float32 on the first superblock (5 layers) of the same weights
    cut = VISION_CUT_SUPERBLOCKS
    cfg32 = dataclasses.replace(cfg, num_layers=cut * cfg.cross_attn_every,
                                param_dtype="float32",
                                activation_dtype="float32")
    p32 = {k: (v[:cut] if k.startswith("sb/") else v).float()
           for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    float32_backends(cfg32, p32, prompt, n_new, extra, cfg32.num_layers,
                     f"{cfg.name} float32, {cfg32.num_layers} layers")
    del p32
    torch.cuda.empty_cache()

    def reduced_extra(c, p):
        p.update(_set_gates(p, VISION_GATE))
        return {"image_embeds": torch.randn(
            b, c.num_image_tokens, c.d_model,
            generator=torch.Generator().manual_seed(args.seed))}

    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 16,
                        extra_for=reduced_extra, num_layers=10)
    return launches["decode_attention"]


# -- phase 6g: MLA (deepseek-v2-236b) ---------------------------------------

MLA_LAYERS = 2          # the depth served on one card: layer 0 (dense) + 1
                        # MoE (each MoE layer adds ~25 s of host-bound init)
MLA_CUT_LAYERS = 2      # its float32 copy: layer 0 + 1 MoE layer
MLA_CHECK_LEN = 1024    # the float32 check's prompt (batch 1)


def _gb(params, prefix, per=1):
    return sum(v.numel() * v.element_size() for k, v in params.items()
               if k.startswith(prefix)) / per / 1e9


def decode_vs_prefill_greedy(eng, prompt, what):
    """The decode path against the prefill path, in float32, token by
    token: a generate's greedy tokens, teacher-forced through the decode
    steps, against a prefill of the prompt and the tokens before each:
    every step's logits within 1e-3 of the largest and each greedy token
    the prefill's argmax.  Returns the largest relative difference."""
    from repro_torch.models import api

    toks = eng.generate({"tokens": prompt})["tokens"]
    lc = teacher_forced(eng, prompt, toks, "ref")
    worst = 0.0
    for i in range(1, toks.shape[1]):
        full = torch.cat([prompt, toks[:, :i]], dim=1)
        _, lp = api.prefill(eng.params, eng.cfg, {"tokens": full})
        require(bool(torch.isfinite(lc[:, i]).all()
                     and torch.isfinite(lp).all()),
                f"{what}: non-finite logits")
        worst = max(worst, float((lc[:, i] - lp).abs().max())
                    / float(lp.abs().max()))
        require(torch.equal(lp.argmax(-1).to(torch.int32), toks[:, i]),
                f"{what}: greedy token {i} of the decode differs from the "
                "prefill's argmax")
    print(f"{what}: {toks.shape[1] - 1} absorbed decode steps after a "
          f"{prompt.shape[1]}-token prefill against a decompressed prefill "
          f"of the prompt and the tokens before each: logits max|diff| = "
          f"{worst:.3g} of the largest; greedy tokens equal")
    return worst


def phase_mla(args):
    """6g. deepseek-v2-236b (MLA over MoE) served on the card at full
    width, cut in depth to ``MLA_LAYERS``; returns the decode attention
    launches of its main path's generate (0: MLA's absorbed decode is
    plain torch ops, as the reference's is plain einsums)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    full = get_config("deepseek-v2-236b")
    meta, _ = api.init_params(full, abstract=True)
    n_full = sum(v.numel() for v in meta.values())
    side = sum(v.numel() for k, v in meta.items()
               if k == "embed/table" or k.endswith("/scale"))
    require(n_full - side == api.analytic_param_count(full),
            "deepseek-v2-236b's matmul parameters != analytic_param_count")
    print(f"model: {full.name} at full width and depth (abstract, meta "
          f"tensors): {n_full} parameters, {_gb(meta, ''):.1f} GB (bf16, "
          f"the norms float32); {n_full - side} matmul parameters (all but "
          f"the embedding table and the norm scales) == "
          f"analytic_param_count; it does not fit one 80 GB card")
    cfg = dataclasses.replace(full, num_layers=MLA_LAYERS)
    m = cfg.moe
    n_moe = cfg.num_layers - m.first_dense_layers
    b, s, n_new = 8, args.prompt_len, args.new_tokens
    rng = np.random.default_rng(args.seed + 4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    params = _init_model(cfg, args.seed)
    print(f"depth cut: {cfg.num_layers} of {full.num_layers} layers (layer "
          f"0 dense, d_ff {m.first_dense_d_ff}; {n_moe} MoE layers of "
          f"{m.num_experts} experts top-{m.top_k} + {m.num_shared_experts} "
          f"shared), full width: d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, q-LoRA {cfg.q_lora_rank}, latent {cfg.kv_lora_rank}, "
          f"rope {cfg.qk_rope_head_dim}, vocab {cfg.vocab_size}; a MoE "
          f"layer carries {_gb(params, 'layers/moe/experts/', n_moe):.3f} GB "
          f"of experts, {_gb(params, 'layers/attn/', n_moe):.3f} GB of MLA "
          f"attention, {_gb(params, 'layers/moe/shared/', n_moe):.3f} GB of "
          f"shared experts; layer 0 {_gb(params, 'layer0/'):.3f} GB; embed "
          f"{_gb(params, 'embed/'):.3f} GB, head {_gb(params, 'head/'):.3f} "
          f"GB")
    read_ms, _, kv_gb = _decode_bound(cfg, params, b, s + n_new)
    eng_rec = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=n_new, step_backend="eager"), device="cuda")
    out_r, routed, per = _routed_experts(eng_rec, prompt)
    del eng_rec
    require(len(per) == n_moe * (n_new - 1),
            f"{len(per)} routings recorded for {n_new - 1} decode steps")
    bound_ms, w_r, _ = _decode_bound(cfg, params, b, s + n_new, routed)
    print(f"decode step bound ({cfg.name}, batch {b}): the experts each "
          f"step routes to, {routed / n_moe:.3f} of {m.num_experts} a MoE "
          f"layer on average ({min(per)}-{max(per)}; at most min(e, B k) = "
          f"{min(m.num_experts, b * m.top_k)}), from an eager generate: "
          f"{w_r:.3f} GB of weights (the MLA, dense, shared and head "
          f"weights, the embedding rows gathered) + {kv_gb:.4f} GB of "
          f"latent cache ({kv_gb / cfg.num_layers * 1e3:.1f} MB a layer at "
          f"{s + n_new} rows: ckv and kpe read once) at 3.35 TB/s = "
          f"{bound_ms:.3f} ms; the port's dispatch runs every expert at "
          f"decode capacity {max(1, int(m.capacity_factor * b * m.top_k / m.num_experts))}"
          f": a read volume of {read_ms:.3f} ms, not a bound")
    out, launches, eng = serve_family(cfg, params, prompt, n_new, 0,
                                      bound_ms)
    toks = out["tokens"]
    require(torch.equal(out_r["tokens"], toks),
            f"{cfg.name}: the recording generate's tokens differ")
    del eng
    int8_generate(cfg, params, prompt, n_new, toks, bound_ms)
    print(f"peak memory of phase 6g: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (weights, "
          "engines' caches, prefill, the int8 copy)")

    # float32: the absorbed decode against the decompressed prefill, on
    # the first layers of the same weights, at batch 1 and a capacity
    # factor at which no MoE pair is dropped (prefill and decode each
    # take their capacity from their own token count, so at the config's
    # 1.25 they would drop different pairs)
    cut = MLA_CUT_LAYERS
    cfg32 = dataclasses.replace(
        cfg, num_layers=cut, param_dtype="float32",
        activation_dtype="float32", moe=dataclasses.replace(
            m, capacity_factor=(m.num_experts + 0.5) / m.top_k))
    p32 = {k: (v[:cut - m.first_dense_layers] if k.startswith("layers/")
               else v).float() for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    e32 = ServingEngine(cfg32, p32, ServeConfig(max_new_tokens=8),
                        device="cuda")
    rel = decode_vs_prefill_greedy(
        e32, prompt[:1, :MLA_CHECK_LEN],
        f"{cfg.name} float32, {cut} layers, batch 1, capacity factor "
        f"{cfg32.moe.capacity_factor:.4f}")
    require(rel <= 1e-3, f"{cfg.name} float32: decode off the prefill by "
            f"{rel}")
    del e32, p32
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(cfg.name, prompt, args.seed, 16)
    return launches["decode_attention"]


# -- phase 6h: LM training --------------------------------------------------

TRAIN_LM_ARCH = "llama3.2-1b"
TRAIN_LM_BATCH = 2      # train_4k's global batch of 256 cut to what one card
#                         holds beside the float32 moments
TRAIN_LM_STEPS = 20     # the run whose loss must fall (launch/train's
#                         OptConfig for --steps 20: warm-up 2, cosine to 20)
TRAIN_LM_SAME = 5       # graph == eager steps from one init
TRAIN_LM_PROFILED = 8   # the run's last graph steps, under the profiler
# (a full-width step takes ~1.5 s on the card: each turn of the rates,
# eager, graph, graph, eager, is one step; steps 8-12 are timed as one
# block without the profiler, and the profiled steps are the last of the
# 20)
# one config per family and attention variant, (arch, vlm gate or None)
TRAIN_VARIANTS = (("llama3.2-1b", None), ("qwen2-moe-a2.7b", None),
                  ("deepseek-v2-236b", None), ("mamba2-370m", None),
                  ("recurrentgemma-9b", None), ("seamless-m4t-medium", None),
                  ("llama-3.2-vision-11b", VISION_GATE))


def _lm_batch(cfg, batch, rng):
    """A ``token_batches`` batch plus the family's source / image: float32
    normals from ``rng`` (at the launcher's zeros the cross-attention
    weights get zero gradients)."""
    from repro_torch.launch.train import token_batches

    out = next(token_batches(cfg.vocab_size, batch, 32,
                             seed=int(rng.integers(1 << 30))))
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal((batch, 24, cfg.d_model),
                                                dtype=np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)
    return out


def _rel_diff(x, ref):
    """max |x - ref| over max |ref| (float)."""
    ref = ref.float()
    return float((x.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


def train_card_vs_cpu(seed):
    """Every family's ``api.loss_fn`` and gradients on the card against
    the CPU, on the reduced configs in float32 (the vision LM at gates
    0.5): the loss within 1e-5 relative, each gradient leaf within 1e-4
    of its largest magnitude.  The card's path differs from the CPU's in
    its kernels only (cuBLAS, the embedding's sorted backward)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.optimizer import value_and_grad

    rng = np.random.default_rng(seed)
    for arch, gate in TRAIN_VARIANTS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        params, _ = api.init_params(cfg, seed=seed, device="cpu")
        if gate is not None:
            params = _set_gates(params, gate)
        batch = {k: torch.from_numpy(v)
                 for k, v in _lm_batch(cfg, 2, rng).items()}
        res = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev) for k, v in params.items()}
            b = {k: v.to(dev) for k, v in batch.items()}
            res[dev] = value_and_grad(lambda pp, bb: api.loss_fn(pp, cfg, bb),
                                      p, b)
        (l_c, _, g_c), (l_g, _, g_g) = res["cpu"], res["cuda"]
        rel = abs(float(l_g) - float(l_c)) / abs(float(l_c))
        worst = max(_rel_diff(g_g[k].cpu(), g_c[k]) for k in g_c)
        require(rel <= 1e-5, f"reduced {arch}: card loss off by {rel:.3g}")
        require(worst <= 1e-4, f"reduced {arch}: card gradients off by "
                f"{worst:.3g} of a leaf's largest")
        print(f"train card vs CPU, reduced {arch} (float32"
              + (f", gates {gate}" if gate is not None else "")
              + f", batch 2 x 32): loss {float(l_g):.6f}, relative diff "
              f"{rel:.3g}; {len(g_c)} gradient leaves, worst max|diff| "
              f"{worst:.3g} of the leaf's largest (bounds 1e-5, 1e-4)")


def head_backward_check(cfg, table, tokens):
    """The float32 logits head's backward on the card (``_MatmulF32``,
    bfloat16 operands; ``table`` the tied embedding) against the cast
    path's autograd on the same operands, at the training step's shape,
    and the milliseconds of its forward and backward."""
    from repro_torch.models.layers import _MatmulF32

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    g = torch.randn((tokens, cfg.vocab_size), generator=gen, device="cuda")
    a, t = x.clone().requires_grad_(), table.detach().clone().requires_grad_()
    _MatmulF32.apply(a, t.t()).backward(g)
    a2, t2 = x.clone().requires_grad_(), table.detach().clone() \
        .requires_grad_()
    torch.matmul(a2.float(), t2.t().float()).backward(g)
    err = max(_rel_diff(a.grad, a2.grad), _rel_diff(t.grad, t2.grad))
    require(a.grad.dtype == t.grad.dtype == torch.bfloat16 and err <= 1e-6,
            f"matmul_f32 backward off the cast path's by {err}")
    del a2, t2
    fwd = host_ms(lambda: _MatmulF32.apply(x, table.t()), iters=5, warmup=1)
    out = _MatmulF32.apply(a, t.t())

    def bwd():
        torch.autograd.grad(out, (a, t), g, retain_graph=True)

    bwd_ms = host_ms(bwd, iters=5, warmup=1)
    flops = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    print(f"logits head backward (_MatmulF32, {tokens} x {cfg.d_model} @ "
          f"{cfg.d_model} x {cfg.vocab_size}): against the cast path's "
          f"autograd, max|diff| {err:.3g} of the largest gradient (bf16 "
          f"grads; bound 1e-6); forward {fwd:.3f} ms (bf16 GEMM, "
          f"float32 out: {flops / fwd / 1e9:.1f} TFLOP/s), backward "
          f"{bwd_ms:.3f} ms (two float32 GEMMs + the table's float32 copy: "
          f"{2 * flops / bwd_ms / 1e9:.1f} TFLOP/s; bound at 67 TFLOP/s "
          f"{2 * flops / FP32_OPS_PER_S * 1e3:.1f} ms)")
    del a, t, out, x, g
    torch.cuda.empty_cache()
    return fwd, bwd_ms


def cli_resume():
    """``repro_torch.launch.train.main`` (the entry point of ``python -m
    repro_torch.launch.train``, called in this process with its argv) on
    the card, reduced llama3.2-1b: 6 steps with ``--ckpt-every 3``, then
    again from that directory, which must resume from step 6 and train
    to step 10."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    outs = []
    with tempfile.TemporaryDirectory() as d:
        for steps in (6, 10):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train.main(["--arch", TRAIN_LM_ARCH, "--steps", str(steps),
                            "--ckpt-every", "3", "--ckpt-dir", d])
            outs.append((buf.getvalue().strip().splitlines(),
                         time.perf_counter() - t0))
    (first, t_first), (second, t_second) = outs
    require(first[-1] == "done" and any(ln.startswith("step 6: loss=")
                                        for ln in first),
            f"launch.train, 6 steps: {first}")
    require("resumed from step 6" in second
            and any(ln.startswith("step 10: loss=") for ln in second),
            f"launch.train resumed: {second}")
    print(f"launch.train --arch {TRAIN_LM_ARCH} (reduced, on the card, "
          f"main() in this process): {' | '.join(first)} ({t_first:.1f} s); "
          f"rerun to --steps 10 from its checkpoints: {' | '.join(second)} "
          f"({t_second:.1f} s)")


def phase_train(args):
    """6h. LM training on the card: full-width llama3.2-1b at train_4k's
    sequence, the graph step against the eager one, every family's
    reduced loss and gradients card == CPU, the launcher's resume.
    Returns the kernel launches of the main path (none: no kernel of the
    port is on it)."""
    import gc

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch.train import token_batches
    from repro_torch.models import api
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    clock = [time.perf_counter()]

    def lap():
        now = time.perf_counter()
        out, clock[0] = now - clock[0], now
        return out

    cfg = get_config(TRAIN_LM_ARCH)
    b, s = TRAIN_LM_BATCH, SHAPES["train_4k"].seq_len
    params = _init_model(cfg, args.seed)
    data = token_batches(cfg.vocab_size, b, s, seed=args.seed)
    batches = [next(data) for _ in range(TRAIN_LM_STEPS)]
    opt = OptConfig(lr=3e-4, warmup_steps=TRAIN_LM_STEPS // 10,
                    total_steps=TRAIN_LM_STEPS)

    def make(step_backend):
        return Trainer(lambda p, bt: api.loss_fn(p, cfg, bt), params,
                       TrainerConfig(total_steps=TRAIN_LM_STEPS, opt=opt,
                                     step_backend=step_backend),
                       device="cuda")

    def steps(t, items):
        return [t.train_step(batches, item) for item in items]

    t_init = lap()
    # the main path: the graph step (captured at its first step) from one
    # init, counts at 0 just before it
    g = make("graph")
    torch.cuda.empty_cache()
    zero_counts()
    metrics = steps(g, batches[:TRAIN_LM_SAME])
    launches = read_counts()
    require(not any(launches.values()),
            f"training launched the port's kernels {launches}: none is on "
            "its path")
    t_graph = lap()
    e = make("eager")
    del params
    m_eager = steps(e, batches[:TRAIN_LM_SAME])
    require(metrics == m_eager, f"graph metrics {metrics} != eager "
            f"{m_eager}")
    for part, x, y in (("params", g.params, e.params),
                       ("m", g.opt_state["m"], e.opt_state["m"]),
                       ("v", g.opt_state["v"], e.opt_state["v"])):
        for k in x:
            require(torch.equal(x[k], y[k]),
                    f"{cfg.name}: graph {part}[{k!r}] != eager, "
                    f"{_rel_diff(x[k], y[k]):.3g} of the largest")
    require(torch.equal(g.opt_state["step"], e.opt_state["step"])
            and int(g.opt_state["step"]) == TRAIN_LM_SAME, "step counter")
    print(f"train step {cfg.name} (full width, batch {b} x {s}, bf16 params, "
          f"float32 moments, remat {cfg.remat_policy!r}): graph == eager "
          f"over {TRAIN_LM_SAME} steps from one init (every step's metrics, "
          f"params, m, v, step bit for bit); capture {g.capture_s:.3f} s "
          "(warm-up on copies of params and moments + capture); the port's "
          f"kernel launches {launches} (none on this path)")
    t_eager = lap()

    # training rate in turns: eager, graph, graph, eager (a step each)
    flops = api.model_flops(cfg, ShapeConfig("train_4k", s, b, "train"))
    rest = iter(batches[TRAIN_LM_SAME:])
    rate = {}
    for name, t in (("eager", e), ("graph", g), ("graph", g),
                    ("eager", e)):
        # the graph run goes on through the batches; the eager trainer,
        # timed only, takes the first of them
        item = next(rest) if name == "graph" else batches[TRAIN_LM_SAME]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.train_step(batches, item)
        rate.setdefault(name, []).append(time.perf_counter() - t0)
        if name == "graph":
            metrics.append(m)
    for name, sec in rate.items():
        print(f"training rate {cfg.name} ({name}): "
              + ", ".join(f"{x * 1e3:.1f} ms a step = {b * s / x:.0f} "
                          f"tokens/s, MFU {flops / x / BF16_OPS_PER_S:.4f}"
                          for x in sec)
              + f" (in turns: eager, graph, graph, eager; MFU = "
              f"model_flops {flops:.4g} (6 N D, N "
              f"{api.analytic_param_count(cfg, active_only=True)}, D "
              f"{b * s}) / step / 989 TFLOP/s; as run, the remat's second "
              f"forward makes it 8 N D = {flops * 8 / 6:.4g})")
    del e
    gc.collect()
    torch.cuda.empty_cache()
    t_turns = lap()

    # the graph run to step TRAIN_LM_STEPS: the steps before the last
    # TRAIN_LM_PROFILED timed as one block, the wall the profiled steps'
    # idle share is read against; the loss must fall
    left = list(rest)
    n_prof = TRAIN_LM_PROFILED
    first = TRAIN_LM_STEPS - n_prof + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += steps(g, left[:-n_prof])
    wall = (time.perf_counter() - t0) / len(left[:-n_prof])
    n_syncs = []

    def profiled():             # host syncs counted under the profiler
        n_syncs.append(_count_syncs(
            lambda: metrics.extend(steps(g, left[-n_prof:]))))

    sec, dev, busy, n_launch, n_copy = _profile_run(profiled)
    launch_calls, syncs = n_launch / n_prof, n_syncs[0] / n_prof
    idle = 1 - busy / (wall * n_prof)
    print(f"training profile ({cfg.name} graph, batch {b} x {s}, steps "
          f"{first}-{TRAIN_LM_STEPS}): {sec:.4f} s under the profiler, "
          f"device busy {busy:.4f} s = {busy / n_prof * 1e3:.4f} ms a step, "
          f"idle share {idle:.4f} against the wall of steps "
          f"{first - len(left[:-n_prof])}-{first - 1} without the profiler "
          f"({wall * 1e3:.4f} ms a step"
          + ("; below 0: the profiled kernel times exceed the unprofiled "
             "wall, so the device idles less than the profiler resolves"
             if idle < 0 else "")
          + f"; {1 - busy / sec:.4f} under it); {launch_calls:.2f} launch "
          "calls and "
          f"{n_copy / n_prof:.2f} memcpy calls a step; {syncs:.2f} host "
          "syncs a step (sync-debug warnings, counted under the profiler); "
          "the top kernels:")
    for a in dev[:10]:
        print(f"  device {_dev_us(a) / 1e3 / n_prof:10.3f} ms a step "
              f"({_dev_us(a) / 1e6 / busy:.3f} of busy)  x "
              f"{a.count // n_prof:5d}  {a.key[:100]}")
    require(len(metrics) == TRAIN_LM_STEPS, f"{len(metrics)} graph steps")
    l1, l20 = metrics[0]["loss"], metrics[-1]["loss"]
    require(math.isfinite(l20) and l20 < l1,
            f"loss did not fall: step 1 {l1}, step {TRAIN_LM_STEPS} {l20}")
    print(f"train {cfg.name} on the graph: loss {l1:.4f} at step 1 -> "
          f"{l20:.4f} at step {TRAIN_LM_STEPS} (ce {metrics[-1]['ce']:.4f}, "
          f"grad norm {metrics[-1]['grad_norm']:.4f}, lr "
          f"{metrics[-1]['lr']:.3g}; launch/train's OptConfig for --steps "
          f"{TRAIN_LM_STEPS})")
    require(launch_calls <= 2, f"{launch_calls} launch calls a graph step")
    require(syncs == 1, f"{syncs} host syncs a graph step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak memory of phase 6h: {peak:.2f} GB (the bf16 params and "
          "float32 moments of two trainers, the capture's copies, the "
          "graph's pool and the eager step's activations and float32 "
          "logits)")
    t_run = lap()
    head_backward_check(cfg, g.params["embed/table"], b * s)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    t_head = lap()
    train_card_vs_cpu(args.seed)
    t_small = lap()
    cli_resume()
    print(f"phase 6h parts: init {t_init:.1f} s, graph steps 1-"
          f"{TRAIN_LM_SAME} with the capture {t_graph:.1f} s, eager steps "
          f"and the comparison {t_eager:.1f} s, turns {t_turns:.1f} s, "
          f"graph run to step {TRAIN_LM_STEPS} with the profile "
          f"{t_run:.1f} s, head backward {t_head:.1f} s, reduced families "
          f"card vs CPU {t_small:.1f} s, launcher {lap():.1f} s")
    return launches

# -- phase 7: the dry run on the card --------------------------------------

DRY_ARCH = "llama3.2-1b"
# decode_32k's batch of 128 cut to 32 (its K/V cache, 34.4 GB, fits
# beside the weights), train_4k's global batch of 256 cut to 1
DRY_DECODE = (32, 32768)
DRY_TRAIN = (1, 4096)
DRY_PEAK_TOL = 0.10     # traced peak against the card's, relative
DRY_TIMED = {"decode": 10, "train": 2}   # steps timed a cell


def _roofline_line(res):
    from repro_torch.launch import roofline

    r = roofline.analyse_run(res)
    return r, (f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
               f"{r['memory_s'] * 1e3:.3f} ms (fused floor "
               f"{r['bytes_per_device'] / 1e9:.3f} GB; traced unfused "
               f"{r['bytes_per_device_raw'] / 1e9:.3f} GB), dominant "
               f"{r['dominant']}, step_time_s {r['step_time_s']:.6f}, "
               f"6ND/traced {r['useful_ratio']:.3f}")


def _card_args(kind, meta_args, params, seq_len, rng):
    """The step's arguments on the card: the drawn weights, zero optimizer
    moments, a zero decode cache at its last position (every key read)
    and token ids from ``rng``."""
    def like(t):
        if t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype, device="cuda")
        return torch.from_numpy(np.asarray(
            rng.integers(0, 1000, tuple(t.shape)), np.int32)).to(
                "cuda", t.dtype)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return like(x)

    rest = [tree(a) for a in meta_args[1:]]
    if kind == "decode":
        rest[0]["pos"].fill_(seq_len - 1)
    require({k: (v.shape, v.dtype) for k, v in meta_args[0].items()}
            == {k: (v.shape, v.dtype) for k, v in params.items()},
            "the card's weights are not the traced step's")
    return (params, *rest)


def dry_cell(kind, params, seed):
    """One cell cut to fit: traced on meta (``run_cell`` and the same
    ``build_step``), then run on the card; returns (traced peak, card
    peak, ms a step, roofline step_time_s, decode_attention launches of
    one step)."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    name = {"decode": "decode_32k", "train": "train_4k"}[kind]
    b, s = DRY_DECODE if kind == "decode" else DRY_TRAIN
    t0 = time.perf_counter()
    res = dryrun.run_cell(DRY_ARCH, name, batch=b, seq_len=s)
    roof, line = _roofline_line(res)
    traced = res["memory"]["temp_bytes"]
    print(f"{DRY_ARCH} {kind} at batch {b} x {s} (meta, {res['trace_s']:.2f}"
          f" s traced): {res['cost']['flops']:.6e} FLOPs, "
          f"{res['cost']['bytes_accessed']:.6e} bytes, arguments "
          f"{res['memory']['argument_bytes'] / 1e9:.3f} GB, peak of the "
          f"step's own {traced} bytes, fits_card {res['fits_card']}; "
          f"roofline: {line}")
    shape = dataclasses.replace(SHAPES[name], global_batch=b, seq_len=s)
    step, meta_args, _ = dryrun.build_step(get_config(DRY_ARCH), shape)
    args = _card_args(kind, meta_args, params, s,
                      np.random.default_rng(seed))
    del meta_args
    out = step(*args)                      # warm-up: workspaces, handles
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = step(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    card = torch.cuda.max_memory_allocated() - base
    del out
    rel = abs(traced - card) / card
    print(f"  peak of the step's own allocations: traced {traced} bytes, "
          f"the card {card} bytes (max_memory_allocated over the step, "
          f"inputs in place), {rel:.4f} apart")
    require(rel <= DRY_PEAK_TOL, f"{kind}: traced peak {traced} bytes "
            f"against the card's {card} ({rel:.4f} > {DRY_PEAK_TOL})")
    n = DRY_TIMED[kind]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = step(*args)
        del out
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"  step on the card (eager, {n} steps back to back): {ms:.3f} ms "
          f"against the roofline's {roof['step_time_s'] * 1e3:.3f} ms: "
          f"{ms / (roof['step_time_s'] * 1e3):.2f}x; cell "
          f"{time.perf_counter() - t0:.1f} s")
    del args
    return traced, card, ms, roof["step_time_s"], launches


def phase_dryrun(args):
    """7. The dry run and its roofline, held against the card; returns
    the kernel launches of its main paths (the cut decode step's, the
    Model Engine's infer)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.fenix_models import fenix_cnn
    from repro_torch.core.model_engine import serving
    from repro_torch.core.model_engine.inference import (EngineModel,
                                                         card_latency_us)
    from repro_torch.data.synthetic_traffic import make_flows
    from repro_torch.launch import dryrun

    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    res = dryrun.run_cell(DRY_ARCH, "decode_32k")
    _, line = _roofline_line(res)
    mem = res["memory"]
    print(f"dry run {DRY_ARCH} x decode_32k (batch {res['global_batch']}, "
          f"{res['seq_len']} keys; meta, traced in {res['trace_s']:.2f} s"
          f"): {res['cost']['flops']:.6e} FLOPs, "
          f"{res['cost']['bytes_accessed']:.6e} bytes accessed, arguments "
          f"{mem['argument_bytes'] / 1e9:.3f} GB, peak of the step's own "
          f"{mem['temp_bytes'] / 1e9:.4f} GB, fits_card {res['fits_card']} "
          f"(card {res['card_bytes'] / 1e9:.2f} GB); roofline: {line} "
          f"[{smi}]")
    require(not res["fits_card"] and res["op_bytes"].get(
        "decode_attention", 0) > 0, "decode_32k: the trace must not fit "
        "one card and must go through decode_attention")
    launches = {name: 0 for name in _counts()}
    params = _init_model(get_config(DRY_ARCH), args.seed)
    peaks = {}
    for kind in ("decode", "train"):
        traced, card, ms, roof_s, got = dry_cell(kind, params, args.seed)
        peaks[kind] = (traced, card, ms, roof_s)
        for name, n in got.items():
            launches[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    layers = get_config(DRY_ARCH).num_layers
    require(launches["decode_attention"] == layers,
            f"the decode step launched decode_attention "
            f"{launches['decode_attention']} times, not {layers}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = fenix_cnn()
    flows = make_flows("iscx", 64, seed=args.seed)
    windows = _calib_windows(flows, 128, mcfg.seq_len)
    require(windows.shape[0] == 128, "128 windows")
    model = EngineModel(mcfg, serving.qparams_from_numpy(
        seeded_qparams(mcfg, args.seed, windows), "cuda"))
    payload = torch.from_numpy(windows).cuda()
    zero_counts()
    model.infer(payload)
    torch.cuda.synchronize()
    got = read_counts()
    launches["int8_gemm"] += got["int8_gemm"]
    require(got["int8_gemm"] == 6, f"infer launched {got} (6 GEMMs)")
    lat = card_latency_us(mcfg, 128)
    eager = host_ms(lambda: model.infer(payload)) * 1e3
    device = device_ms(lambda: model.infer(payload)) * 1e3
    print(f"Model Engine, {mcfg.name} on 128 windows: card_latency_us "
          f"{lat['latency_us']:.4f} us (compute {lat['compute_us']:.4f}, "
          f"memory {lat['memory_us']:.4f}); EngineModel.infer on the card "
          f"{device:.2f} us a call on a graph, {eager:.2f} us eager back to "
          f"back: {device / lat['latency_us']:.1f}x the roofline [{smi}]")
    print(json.dumps({"dryrun": {
        "card": smi, "decode_32k": {
            "flops": res["cost"]["flops"],
            "bytes_accessed": res["cost"]["bytes_accessed"],
            "temp_bytes": mem["temp_bytes"], "fits_card": res["fits_card"]},
        **{kind: {"traced_peak": t, "card_peak": c, "ms": m,
                  "roofline_ms": r * 1e3}
           for kind, (t, c, m, r) in peaks.items()},
        "card_latency_us": lat["latency_us"], "infer_us_graph": device,
        "infer_us_eager": eager}}))
    surface_checks(np.random.default_rng(args.seed), smi)
    return launches


def surface_checks(rng, smi):
    """The reference's call forms on the card: the package re-export,
    decode attention's positional ``ck`` (bit for bit the call without
    it) and the data plane's window rollovers in the reference's
    signatures (the card == a CPU copy).  The ``ck`` calls' launches are
    printed here and kept out of the ``kernels`` line: they check a call
    form, they are not a run of a main path."""
    from repro_torch import get_config
    from repro_torch.core.data_engine import flow_tracker as ft
    from repro_torch.core.data_engine import rate_limiter as rl
    from repro_torch.core.data_engine import state as st
    from repro_torch.kernels.decode_attention import ops

    t0 = time.perf_counter()
    cfg = get_config(DRY_ARCH)
    b, s = 8, 4128
    q, k, v, lens = _attn_inputs(
        rng, b, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
        cfg.head_dim, s, torch.bfloat16,
        rng.integers(1, s + 1, b))
    want = ops.decode_attention(q, k, v, lens)
    zero_counts()
    got = ops.decode_attention(q, k, v, lens, 256)
    torch.cuda.synchronize()
    n_attn = read_counts()["decode_attention"]
    require(n_attn == 1 and torch.equal(got, want),
            f"decode_attention with ck=256: {n_attn} launches, equal "
            f"{torch.equal(got, want)}")
    try:
        ops.decode_attention(q, k, v, lens, 0)
    except ValueError:
        pass
    else:
        require(False, "decode_attention took ck=0")
    zero_counts()
    again = ops.decode_attention(q, k, v, lens, ck=s + 1, backend="cuda")
    torch.cuda.synchronize()
    n_attn += read_counts()["decode_attention"]
    require(n_attn == 2 and torch.equal(again, want),
            f"decode_attention with ck={s + 1} differs")

    p = 4
    lcfg = st.local_engine_config(st.EngineConfig(), p)
    card = st.init_pipes_state(lcfg, p, device="cuda")
    card["flow_cnt"] = torch.from_numpy(
        rng.integers(0, 5000, p).astype(np.int32)).cuda()
    card["win_pkt_cnt"] = torch.from_numpy(
        rng.integers(0, 10**6, p).astype(np.int32)).cuda()
    card["t_last"] = torch.from_numpy(
        rng.integers(10**6, 10**8, p).astype(np.int32)).cuda()
    host = {key: t.cpu() for key, t in card.items()}
    now = card["t_last"].max()
    pairs = {
        "window_reset": (ft.window_reset(card, lcfg, now),
                         ft.window_reset(host, lcfg, now.cpu())),
        "window_reset_pipes": (ft.window_reset_pipes(card, lcfg),
                               ft.window_reset_pipes(host, lcfg)),
        "control_plane_update_pipes": (
            rl.control_plane_update_pipes(card, lcfg, p),
            rl.control_plane_update_pipes(host, lcfg, p))}
    for name, (on_card, on_cpu) in pairs.items():
        for key, t in on_card.items():
            require(t.is_cuda and torch.equal(t.cpu(), on_cpu[key]),
                    f"{name}: {key} on the card differs from the CPU's")
    print(f"the reference's call forms on the card: get_config from the "
          f"package, decode_attention(q, k, v, lengths, 256) at {b} x {s} "
          f"== the call without ck ({n_attn} launches), window_reset / "
          f"window_reset_pipes / control_plane_update_pipes(state, cfg, "
          f"{p}) card == CPU; {time.perf_counter() - t0:.3f} s [{smi}]")


KERNEL_ROWS = (
    ("fused_gate", "src/repro_torch/csrc/fused_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:191"),
    ("fused_gate_prng", "src/repro_torch/csrc/fused_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:171"),
    ("rate_gate", "src/repro_torch/csrc/rate_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:78"),
    ("rate_gate_prng", "src/repro_torch/csrc/rate_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:58"),
    ("int8_gemm", "src/repro_torch/csrc/int8_gemm.cu",
     "src/repro/kernels/int8_matmul/kernel.py:61"),
    ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:71"),
    # the fused gates over a leading pipe dimension (the pipes and farm
    # drivers' launch: one for every pipe's batch), timed at [4, 4096]
    ("fused_gate_pipes", "src/repro_torch/csrc/fused_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:191"),
    ("fused_gate_prng_pipes", "src/repro_torch/csrc/fused_gate.cu",
     "src/repro/kernels/rate_gate/kernel.py:171"),
    # replaces no TPU kernel: the reference's jax.random threefry, which
    # XLA fuses; launched once a chunk step on the main paths
    ("threefry_draw", "src/repro_torch/csrc/threefry_draw.cu", None),
)


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    seconds = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s")
        return out

    phase("1 environment", phase_environment)
    rng = np.random.default_rng(args.seed)
    rows = {**phase("2 gate", phase_gate, rng),
            **phase("2 gate pipes", phase_pipe_gate, rng),
            **phase("2 threefry", phase_threefry, rng),
            **phase("2 select", phase_select, rng),
            "int8_gemm": phase("2 gemm", phase_gemm, rng)}
    launches = phase("3 select sweep", phase_select_sweep, rng)
    slice_launches, ctx = phase("4 slice (CNN)", phase_slice, args)
    launches.update(slice_launches)
    rnn_gemms, rnn_model, rnn_sys = phase("4b RNN", phase_rnn, args, ctx)
    launches["int8_gemm"] += rnn_gemms
    print(f"int8_gemm launches on the main paths: CNN "
          f"{slice_launches['int8_gemm']} + RNN {rnn_gemms}")
    phase("4c oracle payloads", phase_oracle, ctx, rnn_model, rnn_sys)
    del rnn_model, rnn_sys
    phase("4d capture replay", phase_capture, ctx)
    trained_gemms = phase("4e training", phase_training, ctx)
    launches["int8_gemm"] += trained_gemms
    print(f"int8_gemm launches of the trained models' replays: "
          f"{trained_gemms}")
    pipe_launches = phase("4f pipes and farm", phase_pipes, ctx)
    launches["fused_gate_pipes"] = pipe_launches["fused_gate"]
    launches["fused_gate_prng_pipes"] = pipe_launches["fused_gate_prng"]
    launches["int8_gemm"] += pipe_launches["int8_gemm"]
    print(f"int8_gemm launches of the pipes and farm main paths: "
          f"{pipe_launches['int8_gemm']}")
    del ctx
    rows["decode_attention"] = phase(
        "5 attention", phase_attention, rng,
        args.prompt_len + args.new_tokens)
    lm_attn = phase("6 LM", phase_lm, args)
    moe_attn = phase("6b MoE", phase_moe, args)
    ssm_attn = phase("6c ssm", phase_ssm, args)
    hybrid_attn = phase("6d hybrid", phase_hybrid, args)
    encdec_attn = phase("6e encdec", phase_encdec, args)
    vlm_attn = phase("6f vlm", phase_vlm, args)
    mla_attn = phase("6g mla", phase_mla, args)
    train_launches = phase("6h LM training", phase_train, args)
    print(f"kernel launches of the training's main path: {train_launches}")
    dry = phase("7 dry run", phase_dryrun, args)
    launches["int8_gemm"] += dry["int8_gemm"]
    launches["decode_attention"] = lm_attn + moe_attn + ssm_attn \
        + hybrid_attn + encdec_attn + vlm_attn + mla_attn \
        + dry["decode_attention"]
    print(f"decode_attention launches on the main paths: llama3.2-1b "
          f"{lm_attn} + qwen2-moe-a2.7b {moe_attn} + mamba2-370m "
          f"{ssm_attn} + recurrentgemma-9b {hybrid_attn} (its long_500k "
          f"included) + seamless-m4t-medium {encdec_attn} + "
          f"llama-3.2-vision-11b {vlm_attn} + deepseek-v2-236b {mla_attn}"
          f" + the dry run's decode step {dry['decode_attention']}; "
          f"int8_gemm's include the dry run's infer {dry['int8_gemm']}")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.1f} s")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name], **rows[name]}
               for name, src, tpu in KERNEL_ROWS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
