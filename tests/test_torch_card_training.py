"""``chip_smoke.py`` phase 21 (a train step on the card for every model
that no other phase trains and that fits one card) and phase 14's dense
models, rehearsed on the CPU at the smoke configurations with the card's
calls stubbed: the phase's table, its depth cuts, its memory reckoning,
and its functions end to end (losses falling, every leaf with a gradient
moved, the card-against-CPU check for every registered model)."""

import pathlib
from dataclasses import fields

import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.models import model_zoo as tzoo
from repro_torch.train import optim as O
from repro_torch.train.ops import train_state_bytes


@pytest.fixture
def cs(monkeypatch):
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve()
                                    .parents[1]))
    import chip_smoke
    return chip_smoke


def _smoke_card(cs, monkeypatch, lines):
    """The smoke configs in place of the full ones, the card's calls
    stubbed, the log kept in ``lines``."""
    import repro_torch.configs as configs
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch, smoke=False: real(arch, smoke=True))
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(" ".join(
        map(str, a))))
    monkeypatch.setattr(cs, "nvidia_smi_line", lambda: "no card")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)


def test_phase_21_trains_every_model_no_other_phase_trains(cs):
    """The table names every registered model but those phases 12 (12a,
    12b), 15b, 16b, 17a and 18c train and the one that does not fit one
    card."""
    elsewhere = {"qwen2-1.5b", "rwkv6-1.6b", cs.LAUNCH_TRAIN_ARCH,
                 cs.SHARD_TRAIN_ARCH, cs.TP_TRAIN_ARCH}
    assert set(cs.NOT_ON_ONE_CARD) == {"jamba-1.5-large-398b"}
    table = [a for a, _, _, _ in cs.TRAIN_CARD_MODELS]
    assert len(table) == len(set(table))
    assert set(table) == set(ARCH_IDS) - elsewhere - set(cs.NOT_ON_ONE_CARD)
    assert {cs.train_card_optimizer(a) for a in elsewhere} == {"adamw"}
    for arch, _, opt, _ in cs.TRAIN_CARD_MODELS:
        assert cs.train_card_optimizer(arch) == opt
    # the learning rate at step 1 is not 0 under the warm-up
    assert float(O.cosine_schedule(cs.TRAIN_LR, 0,
                                   cs.TRAIN_CARD_STEPS)(0)) > 0


def test_only_a_bf16_leaf_the_step_reached_may_stay(cs):
    """A leaf that had a gradient and did not move fails, unless it is a
    bf16 leaf with no fp32 copy (its update below half an ulp) whose
    optimizer state moved; a leaf with no gradient is not held."""
    bf, f32 = torch.ones(3, dtype=torch.bfloat16), torch.ones(3)
    paths = ["a", "b", "c", "d", "e"]
    grad = [True, True, True, True, False]
    moved = [True, False, False, False, False]
    held = [bf, bf, bf, f32, bf]
    reached = {"a", "b", "d", "e"}
    failed, below = cs.unmoved_leaves(paths, grad, moved, held,
                                      lambda p: p in reached)
    assert (failed, below) == (["c", "d"], ["b"])


def _layer_kinds(cfg) -> set:
    """The kinds of layer a config builds (the model's ``Slot``s: mixer,
    MLP, causal, gated), encoder and decoder both."""
    from repro_torch.models.transformer import layer_plan
    plans = ([layer_plan(cfg, cfg.enc_layers, decoder=False),
              layer_plan(cfg, cfg.dec_layers)] if cfg.family == "encdec"
             else [layer_plan(cfg, cfg.n_layers)])
    return {s for pre, _, pat in plans for s in pre + pat}


def _cut_configs(cs):
    rows = [(cfg, reduced) for cfg, _, reduced in cs.train_card_configs()]
    return rows + [(cfg, cuts) for cfg, cuts in cs.family_configs()
                   if cfg.family == "dense"]


def test_each_cut_keeps_every_layer_kind_at_full_width(cs):
    """Phase 21's depth cuts, and phase 14's of the dense models: the
    layer kinds of the full config (deepseek's dense and MoE layers,
    vision's self- and cross-attention) and every width unchanged."""
    for cfg, reduced in _cut_configs(cs):
        full = tget(cfg.name)
        assert _layer_kinds(cfg) == _layer_kinds(full), cfg.name
        changed = {f.name for f in fields(full)
                   if getattr(full, f.name) != getattr(cfg, f.name)}
        assert changed <= {"n_layers"}, (cfg.name, changed)
        assert bool(changed) == ("n_layers" in reduced)
        if changed:
            assert reduced["why"] and cfg.n_layers < full.n_layers
    kinds = {cfg.name: _layer_kinds(cfg)
             for cfg, _, _ in cs.train_card_configs()}
    assert {s.mlp for s in kinds["deepseek-v2-lite-16b"]} == {"dense", "moe"}
    assert {s.mixer for s in kinds["llama-3.2-vision-90b"]} == \
        {"attn", "cross"}
    assert {s.mixer for s in kinds["seamless-m4t-medium"]} == \
        {"attn", "attn_cross"}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_the_reckoning_is_params_times_the_optimizers_bytes(cs, opt):
    """bf16 weights and fp32 gradients, 6 B a parameter, and AdamW's fp32
    master and moments, 12 more: the optimizer's own state, from shapes
    only, is those bytes (Adafactor's factored moments below 1% of
    them)."""
    for cfg, o, _ in cs.train_card_configs():
        assert cs.train_reckoning(cfg, opt) == \
            cfg.param_counts()["total"] * (18 if opt == "adamw" else 6)
    cfg = tget("qwen1.5-4b")
    n = tzoo.param_count(cfg)
    state = train_state_bytes(cfg, O.make_optimizer(cfg, opt))
    if opt == "adamw":
        assert state + 4 * n == cs.OPT_BYTES[opt] * n
    else:
        assert 0 < state + 4 * n - cs.OPT_BYTES[opt] * n < \
            0.01 * cs.OPT_BYTES[opt] * n


def test_chip_smoke_phase_21_rehearses_on_the_cpu(cs, monkeypatch):
    """Phase 21 end to end on the CPU at the smoke configs (cut as the
    table cuts the full ones): three steps of each model with the loss
    falling and every leaf that had a gradient moved, then the
    card-against-CPU check for every registered model; no kernel
    launched."""
    lines = []
    _smoke_card(cs, monkeypatch, lines)
    monkeypatch.setattr(cs, "TRAIN_S", 32)
    counts = cs.card_training_phase(torch.device("cpu"))
    assert not any(counts.values())
    for arch, _, opt, _ in cs.TRAIN_CARD_MODELS:
        assert any(ln.startswith(f"phase 21: {arch}-smoke") and opt in ln
                   for ln in lines), arch
    checked = [ln for ln in lines if ln.startswith("  card vs CPU (")]
    # each within CPU_TOL, or the phase raises
    assert [ln.split("(")[1].split()[0] for ln in checked] == list(ARCH_IDS)


def test_phase_21_fails_a_leaf_that_does_not_move(cs, monkeypatch):
    """The moved-leaf check can fail: with the optimizer's update of one
    leaf undone, the phase raises naming it."""
    lines = []
    _smoke_card(cs, monkeypatch, lines)
    monkeypatch.setattr(cs, "TRAIN_S", 16)
    real = O.make_optimizer

    def frozen_norm(*a, **k):
        opt = real(*a, **k)

        def update(grads, state, params, step):
            keep = params["final_norm"]["scale"].clone()
            params, state = opt.update(grads, state, params, step)
            params["final_norm"]["scale"].copy_(keep)
            return params, state
        return O.Optimizer(opt.init, update, opt.state_axes)
    monkeypatch.setattr(O, "make_optimizer", frozen_norm)
    cfg, opt, reduced = cs.train_card_configs()[1]      # qwen1.5-4b
    with pytest.raises(AssertionError, match=r"final_norm.*scale"):
        cs.train_card(torch.device("cpu"), cfg, opt, reduced)


def test_chip_smoke_phase_14_serves_the_dense_models_on_the_cpu(
        cs, monkeypatch):
    """Phase 14's three dense models (squared ReLU and decoder-only
    LayerNorm; full multi-head attention with QKV bias; 96-on-8 heads at
    rope theta 1e6, cut to 16 layers) through ``families_phase`` at the
    smoke configs, then their smoke configs' prefill on the "card" against
    the CPU: no kernel launched."""
    lines = []
    _smoke_card(cs, monkeypatch, lines)
    dense = tuple(r for r in cs.FAMILY_MODELS
                  if tget(r[0]).family == "dense")
    assert [r[0] for r in dense] == ["nemotron-4-15b", "qwen1.5-4b",
                                     "mistral-large-123b"]
    monkeypatch.setattr(cs, "FAMILY_MODELS", dense)
    monkeypatch.setattr(cs, "PREFILL_CPU_MODELS",
                        tuple(r[0] for r in dense))
    for name, value in (("PROMPT", 8), ("NEW_TOKENS", 3), ("MAX_LEN", 16),
                        ("N_REQUESTS", 3), ("SERVE_BATCH", 2),
                        ("PREFILL_CPU_B", 2), ("PREFILL_CPU_S", 8)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "decode_step_profile",
                        lambda cfg, params, caches, tokens: {})
    paths = cs.families_phase(torch.device("cpu"))
    assert set(paths) == {f"serve/{r[0]}-smoke" for r in dense}
    assert not any(v for c in paths.values() for v in c.values())
    served = [ln for ln in lines if ln.startswith("phase 14: serving ")]
    assert len(served) == 3 and "reduced" in served[2]
    held = [ln for ln in lines if "logits max |card - cpu|" in ln]
    assert len(held) == 3


def test_device_events_sum_the_raw_events_by_name():
    """The profiler's device rows (phases 10-14 and 12's profiled steps,
    the profilers): each kernel's and copy's device intervals summed by
    name from the raw events, the host ops, async events and the
    profiler's own buffer requests left out, the largest first; a name
    whose time sums to 0 is dropped."""
    from types import SimpleNamespace as NS
    from repro_torch.launch.profile_stream import _device_events
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(name, dev, start, end, is_async=False):
        return NS(name=lambda: name, device_type=lambda: dev,
                  start_ns=lambda: start, end_ns=lambda: end,
                  is_async=lambda: is_async, start_thread_id=lambda: 1,
                  end_thread_id=lambda: 1)
    events = [evt("aten::mm", cpu, 1_000, 901_000),
              evt("gemm", cuda, 2_000, 252_000),
              evt("Memcpy HtoD", cuda, 5_000, 45_000),
              evt("gemm", cuda, 300_000, 1_050_000),
              evt("Activity Buffer Request", cuda, 0, 5_000_000),
              evt("noop", cuda, 7_000, 7_000),
              evt("scan", cuda, 10_000, 1_510_000),
              evt("scan", cuda, 10_000, 2_000_000, is_async=True)]
    prof = NS(profiler=NS(kineto_results=NS(
        trace_start_ns=lambda: 1_000, events=lambda: events)))
    assert _device_events(prof) == [(1.5, 2, "scan"), (1.0, 2, "gemm"),
                                    (0.04, 1, "Memcpy HtoD")]
