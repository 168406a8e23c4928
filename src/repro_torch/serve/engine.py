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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch._device import (DeviceLike, no_host_sync, resolve_device,
                                 validate_backend)
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


class ParamStore(nn.Module):
    """The flat parameter dict as buffers, keyed as in the reference, so
    that ``.to(device)`` moves every weight."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, v)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 scfg: ServeConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        validate_backend(scfg.attn_backend, "attn_backend")
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """batch: tokens [B,S] (tensor or array). Greedy decode; returns
        the tokens [B, max_new_tokens] and the prefill and decode wall
        times (each ends in a device synchronise)."""
        cfg, scfg = self.cfg, self.scfg
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        b, s = tokens.shape
        self._sync()
        t0 = time.perf_counter()
        cache, logits = api.prefill(self.params, cfg, {"tokens": tokens})
        cache = api.grow_cache(cfg, cache, b, s, s + scfg.max_new_tokens)
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        self._sync()
        t1 = time.perf_counter()
        with no_host_sync(self.device):
            for _ in range(scfg.max_new_tokens - 1):
                cache, logits = api.decode_step(
                    self.params, cfg, cache, toks[-1],
                    attn_backend=scfg.attn_backend)
                toks.append(torch.argmax(logits, -1).to(torch.int32))
        self._sync()
        dt = time.perf_counter() - t1
        return {"tokens": torch.stack(toks, dim=1),
                "decode_tok_per_s": (scfg.max_new_tokens - 1) * b
                / max(dt, 1e-9),
                "prefill_s": t1 - t0, "decode_s": dt}

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
