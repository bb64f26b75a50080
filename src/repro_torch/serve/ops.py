"""Serving as a placement-priced operator graph: ``prefill -> decode``
over the pipeline substrate, as the JAX package's ``serve/ops.py``. The
prefill->decode crossing is a real link hop and the KV cache is the
state the placement DP prices against ``mem_cap``.

Both ops are host ops (``Op.jit=False``) built around one
:class:`~repro_torch.serve.engine.ServeEngine`: they call the engine's
own ``_prefill``/``_decode`` steps with the same seed threading, so the
graph path is bitwise-identical to ``ServeEngine._serve_wave``. The KV
cache crosses between them as the ``"kv"`` batch channel (a cache tree);
the ``"rng"`` channel is the wave's integer seed as a 0-dim int64 CPU
tensor.

``decode`` declares ``OperatorCost.downlink_ok``: its flow parent may sit
in the cloud and ship the cache *down*, so ``{decode}`` is a legal
frontier (cloud-prefill/edge-decode).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._tree import tree_bytes
from repro_torch.core.costmodel import OperatorCost
from repro_torch.core.pipeline import Op, OpGraph
from repro_torch.launch.roofline import dl_operator_cost
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.engine import (ServeEngine, sample_with_seed,
                                      split_seed, wave_inputs)


def param_bytes(cfg) -> float:
    """Resident bytes of the model weights (shapes only, nothing
    allocated)."""
    return tree_bytes(zoo.param_shapes(cfg))


def kv_cache_bytes(cfg, batch: int, max_len: int, src_len: int = 0) -> float:
    """Resident bytes of a full KV-cache tree at ``(batch, max_len)`` —
    the decode op's placement-priced state, from shapes only (a cache
    on the ``meta`` device)."""
    return tree_bytes(zoo.init_caches(cfg, batch, max_len, src_len,
                                       device="meta"))


def _model_extra_keys(cfg) -> Tuple[str, ...]:
    if cfg.family == "vlm":
        return ("patches",)
    if cfg.family == "encdec":
        return ("frames",)
    return ()


def prefill_op(engine: ServeEngine, *, prompt_len: int,
               cost: Optional[OperatorCost] = None) -> Op:
    """The prefill stage as a host op: run the engine's prefill, sample
    the first token (the engine's seed threading), and emit the KV cache
    on the ``"kv"`` channel — the state the downlink ships."""
    cfg = engine.cfg
    extras = _model_extra_keys(cfg)

    def fn(state, batch):
        model_in = {"tokens": batch["tokens"],
                    **{k: batch[k] for k in extras}}
        logits, caches = engine._prefill(engine.params, model_in)
        rng, sub = split_seed(int(batch["rng"]))
        tok = sample_with_seed(logits[:, 0, :cfg.vocab_size], sub,
                               engine.sampling)
        return state, {"kv": caches, "tok": tok,
                       "rng": torch.tensor(rng, dtype=torch.int64)}

    if cost is None:
        B = engine.batch_size
        kvb = kv_cache_bytes(cfg, B, engine.max_len)
        cost = dl_operator_cost(
            "prefill", cfg, phase="prefill", batch=B, seq_len=prompt_len,
            param_bytes=param_bytes(cfg),
            # the KV cache is what this op emits downstream, per event
            out_bytes_per_event=kvb / B,
            state_bytes=param_bytes(cfg))
    return Op("prefill", fn, cost, jit=False,
              reads=("tokens", "rng") + extras, writes=("kv", "tok", "rng"))


def decode_op(engine: ServeEngine, *, max_new_tokens: int,
              cost: Optional[OperatorCost] = None) -> Op:
    """The decode loop as a host op: consume the ``"kv"`` channel and the
    first sampled token, run the engine's decode step ``max_new_tokens -
    1`` times, and emit every request's tokens as ``"out_tokens"``
    (B, max_new_tokens). Declares ``downlink_ok`` and deletes its inputs:
    the decode steps update the cache in place, so the stale references
    must not survive in the channel env."""
    cfg = engine.cfg
    steps = max_new_tokens - 1

    def fn(state, batch):
        caches, tok, rng = batch["kv"], batch["tok"], int(batch["rng"])
        toks = [tok]
        for _ in range(steps):
            tok, caches, rng = engine._decode(engine.params, caches,
                                              tok[:, None], rng)
            toks.append(tok)
        out = torch.stack(toks, dim=1).to(torch.int32)
        return state, {"out_tokens": out,
                       "rng": torch.tensor(rng, dtype=torch.int64)}

    if cost is None:
        B = engine.batch_size
        pb = param_bytes(cfg)
        kvb = kv_cache_bytes(cfg, B, engine.max_len)
        cost = dl_operator_cost(
            "decode", cfg, phase="decode", batch=B, seq_len=0,
            new_tokens=max_new_tokens, param_bytes=pb,
            out_bytes_per_event=4.0 * max_new_tokens,
            # the decode-resident state the DP prices against mem_cap:
            # the weights AND the live KV cache
            state_bytes=pb + kvb, downlink_ok=True)
    return Op("decode", fn, cost, jit=False, reads=("kv", "tok", "rng"),
              writes=("out_tokens", "rng"), deletes=("kv", "tok"))


def serving_graph(engine: ServeEngine, *, prompt_len: int,
                  max_new_tokens: int) -> OpGraph:
    """The split serving graph ``prefill -> decode`` (one flow edge — the
    KV-cache hop placement prices per link). Frontiers are ``{}``,
    ``{prefill, decode}``, ``{prefill}`` and — via decode's
    ``downlink_ok`` — ``{decode}``."""
    return OpGraph([
        prefill_op(engine, prompt_len=prompt_len),
        decode_op(engine, max_new_tokens=max_new_tokens),
    ])


def serve_wave_batch(engine: ServeEngine, prompts, *, seed: int = 0):
    """The channel env for one wave of ``prompts`` (list of int 1-D
    arrays): left-padded tokens exactly as ``ServeEngine._serve_wave``
    builds them, family extras, and the wave's seed."""
    batch = wave_inputs(engine.cfg, prompts, engine.device)
    batch["rng"] = torch.tensor(int(seed), dtype=torch.int64)
    return batch
