"""LM serving engine: prefill/decode with KV cache + FENIX admission gate.

Port of ``repro/serve/engine.py``.  Static-batch greedy decode over the
uniform Model API: prefill, grow the cache to prefill_len + max_new,
run ``decode_step`` repeatedly, optionally with int8 weights (Model
Engine quantization) and the ServeGate admitting requests — the FENIX
pattern applied to LM inference.

The engine runs on ``device`` (``None`` means ``cuda``).  Its decode
attention takes ``ServeConfig.attn_backend``: ``"cuda"`` (the default on
the card) runs the hand-written kernel, ``"ref"`` the model's einsum
path (the default on the CPU).  On CUDA the decode loop runs under
``torch.cuda.set_sync_debug_mode("error")``: an operation that waits
for the host raises.

The reference jits its decode step.  Here one step body, over every
layer, reads each sequence's last token from a [B, max_new_tokens]
device buffer at the cache's device position, writes the new K/V rows
and the greedy token back at that position, and advances it.  With
``ServeConfig.step_backend="graph"`` (the default on CUDA) the body is
captured as a CUDA graph once per shape on the engine and replayed
each step; ``"eager"`` (the default on the CPU) runs it op
by op.  Prefill stays eager and writes into the grown cache, which is
allocated once per shape and kept with the graph, so ``serve_requests``
reuses both across requests of one shape.  A shape is (batch, prompt
length, source length): the encoder-decoder's ``src_embeds`` and the
vision LM's ``image_embeds`` set the length of the cross K/V, and
requests with two source lengths get a cache and a graph each.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import _graph
from repro_torch._device import (DeviceLike, no_host_sync, resolve_device,
                                 resolve_step_backend, validate_backend)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.gate import GateConfig, ServeGate
from repro_torch.models import api


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    greedy: bool = True
    quant: str = "none"          # "none" | "int8"
    gate_backend_rate: Optional[float] = None  # req/s; None = ungated
    attn_backend: Optional[str] = None  # "cuda" | "ref"; None: per device
    step_backend: Optional[str] = None  # "graph" | "eager"; None: per device


class ParamStore(nn.Module):
    """The flat parameter dict as buffers, keyed as in the reference, so
    that ``.to(device)`` moves every weight."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, v)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())


def _weights_of(engine: "ServingEngine"):
    """The weights the engine's decode step reads, as a function that a
    graph can hold without a reference cycle to the engine."""
    ref = weakref.ref(engine)
    return lambda: list(ref().params.values())


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 scfg: ServeConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        validate_backend(scfg.attn_backend, "attn_backend")
        self.step_backend = resolve_step_backend(scfg.step_backend,
                                                 self.device)
        if scfg.quant == "int8":
            # FENIX Model Engine INT8 applied to the LM weights
            _, axes = api.init_params(cfg, abstract=True)
            params, _ = api.quantize_for_serving(cfg, params, axes)
        self.weights = ParamStore(params).to(self.device)
        self.params = self.weights.as_dict()
        self.gate: Optional[ServeGate] = None
        if scfg.gate_backend_rate:
            self.gate = ServeGate(GateConfig(
                backend_rate=scfg.gate_backend_rate))
        # by (batch, prompt length, source length or None): the decode
        # buffers (grown cache, token buffer) and, on "graph", the
        # captured step
        self._decode_bufs: Dict[Tuple[int, int, Optional[int]],
                                Dict[str, Any]] = {}
        self._graphs: Dict[Tuple[int, int, Optional[int]],
                           _graph.Graph] = {}
        self._pool = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_body(self, s: int):
        """The decode step over the buffers ``bufs`` ({"cache", "tokens"})
        of a prompt of ``s`` tokens: the input is column ``pos - s`` of
        the token buffer, the greedy token goes to column ``pos - s + 1``,
        and the cache's K/V rows, recurrent states and ``pos`` advance in
        place."""
        cfg, backend = self.cfg, self.scfg.attn_backend

        def body(bufs):
            cache, out = bufs["cache"], bufs["tokens"]
            col = (cache["pos"] - s).reshape(1).long()
            tok = out.index_select(1, col).reshape(-1)
            new, logits = api.decode_step(self.params, cfg, cache, tok,
                                          attn_backend=backend)
            out.index_copy_(1, col + 1,
                            torch.argmax(logits, -1).to(torch.int32)[:, None])
            cache["pos"].copy_(new["pos"])

        return body

    def generate(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """batch: tokens [B,S] (tensor or array; encdec: + src_embeds
        [B,S_src,d], vlm: + image_embeds [B,S_img,d]). Greedy decode; returns
        the tokens [B, max_new_tokens] and the wall times of the prefill
        (``prefill_s``), of the decode step's capture (``capture_s``: 0
        when the graph of this shape is reused, and on "eager") and of the
        decode loop (``decode_s``), each ending in a device synchronise.
        ``decode_tok_per_s`` counts the decode loop only: graph replays on
        "graph", eager steps on "eager"."""
        cfg, scfg = self.cfg, self.scfg
        inputs = {k: torch.as_tensor(batch[k]).to(self.device)
                  for k in ("tokens", "src_embeds", "image_embeds")
                  if k in batch}
        b, s = inputs["tokens"].shape
        src = inputs.get("src_embeds", inputs.get("image_embeds"))
        src_len = None if src is None else src.shape[1]
        n_new = scfg.max_new_tokens
        key = (b, s, src_len)
        self._sync()
        t0 = time.perf_counter()
        cache, logits = api.prefill(self.params, cfg, inputs)
        del inputs, src
        bufs = self._decode_bufs.get(key)
        if bufs is None:
            bufs = self._decode_bufs[key] = {
                "cache": api.grow_cache(cfg, cache, b, s, s + n_new,
                                        src_len=src_len),
                "tokens": torch.zeros((b, n_new), dtype=torch.int32,
                                      device=self.device)}
        else:
            api.grow_cache(cfg, cache, b, s, s + n_new, src_len=src_len,
                           out=bufs["cache"])
        del cache
        bufs["tokens"][:, 0] = torch.argmax(logits, -1).to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        body = self._decode_body(s)
        if any(g.stale() for g in self._graphs.values()):   # weights moved
            self._graphs.clear()
            self._pool = None     # a pool outlives no graph of its own
        graph, capture_s = self._graphs.get(key), 0.0
        if self.step_backend == "graph" and graph is None and n_new > 1:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # the warm-up writes one K/V row at pos (a ring slot at pos %
            # window) and the token after it, which the first replay
            # rewrites; the entries without a kv_seq axis (pos, recurrent
            # states, conv tails) it would advance, so it runs on copies
            scratch = tuple(("cache", k) for k, (_, _, axes) in
                            api.cache_specs(cfg, b, s + n_new,
                                            src_len=src_len).items()
                            if "kv_seq" not in axes)
            graph = self._graphs[key] = _graph.capture(
                body, bufs, self.device, pool=self._pool, scratch=scratch,
                reads=_weights_of(self))
            capture_s = graph.seconds
        t2 = time.perf_counter()
        with no_host_sync(self.device):
            for _ in range(n_new - 1):
                if graph is not None:
                    graph.replay()
                else:
                    body(bufs)
        self._sync()
        dt = time.perf_counter() - t2
        return {"tokens": bufs["tokens"].clone(),
                "decode_tok_per_s": (n_new - 1) * b / max(dt, 1e-9),
                "prefill_s": t1 - t0, "capture_s": capture_s,
                "decode_s": dt}

    def serve_requests(self, arrivals: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
        """Gated request admission: each arrival {stream, t_us, batch}."""
        admitted, denied = [], 0
        for req in arrivals:
            if self.gate is None or self.gate.offer(req["stream"],
                                                    req["t_us"]):
                admitted.append(req)
            else:
                denied += 1
        results = [self.generate(r["batch"]) for r in admitted]
        return {"admitted": len(admitted), "denied": denied,
                "results": results,
                "gate_stats": None if self.gate is None else
                {"admitted": self.gate.admitted,
                 "denied": self.gate.denied}}
