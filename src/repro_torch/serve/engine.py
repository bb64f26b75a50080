"""Serving engine: batched prefill + autoregressive decode over the ported
model families, with request slots (waves of up to ``batch_size``
requests, each left-padded to the wave's longest prompt), as the JAX
package's ``serve/engine.py``.

The decode step reuses one cache per wave and updates it in place (the
reference donates it to its jitted step). KV caches can be held in int8
(``cfg.kv_cache_dtype="int8"``): values are cast with XLA's saturating
conversion, as the reference stores them.

Randomness: the engine's ``rng`` is an integer seed, split into (next,
sub) by :func:`split_seed` at each draw, where the reference splits a
``jax.random`` key at the same points; a sampled draw uses a
``torch.Generator`` seeded with ``sub`` on the logits' device.

The default ``impl`` is ``"kernel"``: cross-attention runs the flash
kernel and RWKV6 the WKV kernel (on the CPU, their plain versions).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.sampling import SamplingParams, sample


def split_seed(seed: int) -> Tuple[int, int]:
    """``(next seed, sub seed)`` from ``seed`` (the key split of the
    reference's engine)."""
    g = torch.Generator().manual_seed(int(seed))
    a, b = torch.randint(0, 2 ** 62, (2,), generator=g).tolist()
    return a, b


def sample_with_seed(logits: torch.Tensor, seed: int,
                     p: SamplingParams) -> torch.Tensor:
    """:func:`sample` with a generator seeded by ``seed`` on the logits'
    device (none is made for greedy decoding)."""
    gen = None
    if not p.greedy:
        gen = torch.Generator(device=logits.device).manual_seed(int(seed))
    return sample(logits, gen, p)


def wave_inputs(cfg: ArchConfig, prompts, device) -> dict:
    """The model inputs of one wave: prompts left-padded with token 0 to
    the longest, and the family's zero stub embeddings (audio ``frames``
    for enc-dec, ``patches`` for vlm), as the reference builds them."""
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = np.asarray(p, np.int32)      # left-pad
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros(
            (B, cfg.frontend_len, cfg.frontend_dim), dtype=torch.float32,
            device=device)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, S, cfg.frontend_dim),
                                      dtype=torch.float32, device=device)
    return batch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, impl: str = "kernel",
                 sampling: SamplingParams = SamplingParams(greedy=True),
                 seed: int = 0,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg, self.params = cfg, params
        self.batch_size, self.max_len = batch_size, max_len
        self.impl, self.sampling = impl, sampling
        # injectable so serving metrics are deterministic under a sim
        # clock (tests advance it by hand); default wall clock
        self._clock = clock
        self.rng = int(seed)
        self.metrics = {"prefill_tokens": 0, "decode_tokens": 0,
                        "prefill_s": 0.0, "decode_s": 0.0}

    @property
    def device(self) -> torch.device:
        return zoo.params_device(self.params)

    # -- the two steps ------------------------------------------------------
    def _prefill(self, params, batch):
        return zoo.prefill(params, self.cfg, batch, max_len=self.max_len,
                           impl=self.impl)

    def _decode(self, params, caches, tokens, rng: int):
        """One decode step on ``caches`` (updated in place): ``(next
        tokens, caches, next rng)``."""
        logits, caches = zoo.decode_step(params, self.cfg, caches, tokens,
                                         impl=self.impl)
        rng, sub = split_seed(rng)
        next_tok = sample_with_seed(logits[:, 0, :self.cfg.vocab_size], sub,
                                    self.sampling)
        return next_tok, caches, rng

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- public API -------------------------------------------------------
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests with slot-based batching."""
        pending = list(requests)
        done: List[Request] = []
        while pending:
            wave = pending[:self.batch_size]
            pending = pending[self.batch_size:]
            self._serve_wave(wave)
            done.extend(wave)
        return done

    def _serve_wave(self, wave: List[Request]):
        cfg = self.cfg
        B = len(wave)
        batch = wave_inputs(cfg, [r.prompt for r in wave], self.device)
        S = batch["tokens"].shape[1]
        steps = max(r.max_new_tokens for r in wave) - 1
        if S + steps > self.max_len:
            raise ValueError(f"prompt ({S}) + new tokens ({steps + 1}) do "
                             f"not fit max_len {self.max_len}")

        t0 = self._clock()
        logits, caches = self._prefill(self.params, batch)
        self.rng, sub = split_seed(self.rng)
        tok = sample_with_seed(logits[:, 0, :cfg.vocab_size], sub,
                               self.sampling)
        self._sync()
        self.metrics["prefill_s"] += self._clock() - t0
        self.metrics["prefill_tokens"] += B * S
        for i, t in enumerate(tok.tolist()):
            wave[i].out_tokens.append(int(t))

        t1 = self._clock()
        for _ in range(steps):
            tok, caches, self.rng = self._decode(
                self.params, caches, tok[:, None], self.rng)
            for i, t in enumerate(tok.tolist()):
                r = wave[i]
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(t))
        self._sync()
        self.metrics["decode_s"] += self._clock() - t1
        self.metrics["decode_tokens"] += B * steps
        for r in wave:
            r.done = True

    def throughput(self) -> dict:
        m = self.metrics
        return {
            "prefill_tok_per_s": m["prefill_tokens"] / max(m["prefill_s"], 1e-9),
            "decode_tok_per_s": m["decode_tokens"] / max(m["decode_s"], 1e-9),
        }
