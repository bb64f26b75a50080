"""The port's serving path (``repro_torch.serve``) against the JAX
package's, on the CPU, at the smoke configurations (fp32).

Greedy tokens must be the reference's, token for token: rwkv6 and
seamless with the reference's Pallas kernels in interpret mode against
the port's ``impl="kernel"`` (their plain versions here), qwen2 on the
chunked path in both. The serving graph at the ``{decode}`` frontier must
be bitwise the port's own engine; its costs (``param_bytes``,
``kv_cache_bytes``, ``dl_operator_cost``) and placement plans must be the
reference's exactly. Sampled draws cannot match ``jax.random``; the
sampling masks must.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.core import costmodel as jcm
from repro.core import placement as jplace
from repro.launch import roofline as jroof
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve import ops as jops
from repro.serve import sampling as jsampling

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.core import costmodel as tcm
from repro_torch.core import placement as tplace
from repro_torch.kernels import ops as kops
from repro_torch.launch import roofline as troof
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import engine as tengine
from repro_torch.serve import ops as tops
from repro_torch.serve import sampling as tsampling

ARCHS = ("qwen2-1.5b", "rwkv6-1.6b", "seamless-m4t-medium",
         "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "llama-3.2-vision-90b",
         "mistral-large-123b", "nemotron-4-15b", "qwen1.5-4b")
_CACHE = {}


def _model(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _CACHE:
        jc = replace(jget(arch, smoke=True), **over)
        tc = replace(tget(arch, smoke=True), **over)
        jp = jzoo.init_params(jc, 0)
        tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")
        _CACHE[key] = (jc, tc, jp, tp)
    return _CACHE[key]


def _prompts(vocab, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(3, 9))
                         ).astype(np.int32) for _ in range(n)]


def _serve(pkg, cfg, params, prompts, impl, new_tokens=5, **kw):
    eng = pkg.ServeEngine(cfg, params, batch_size=2, max_len=24, impl=impl,
                          **kw)
    reqs = [pkg.Request(i, p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return eng, [r.out_tokens for r in reqs]


# ---------------------------------------------------------------------------
# greedy tokens: the reference's, token for token
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,jimpl,timpl", [
    ("rwkv6-1.6b", "pallas", "kernel"),
    ("seamless-m4t-medium", "pallas", "kernel"),
    ("qwen2-1.5b", "chunked", "chunked"),
    # squared ReLU and LayerNorm in a decoder-only stack
    ("nemotron-4-15b", "chunked", "chunked"),
])
def test_greedy_tokens_equal_the_reference(arch, jimpl, timpl, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    jc, tc, jp, tp = _model(arch)
    prompts = _prompts(jc.vocab_size)   # 3 requests, 2 waves, left-padded
    _, want = _serve(jengine, jc, jp, prompts, jimpl)
    kops.reset_launch_counts()
    eng, got = _serve(tengine, tc, tp, prompts, timpl)
    assert got == want
    # on the CPU the plain versions run: no kernel launched
    assert set(kops.launch_counts().values()) == {0}
    # each wave counts its requests times its longest (left-padded) prompt
    assert eng.metrics["prefill_tokens"] == sum(
        len(w) * max(len(p) for p in w) for w in (prompts[:2], prompts[2:]))


def test_int8_kv_cache_serves_the_references_tokens():
    """The int8 cache stores k and v with XLA's saturating cast."""
    jc, tc, jp, tp = _model("qwen2-1.5b", kv_cache_dtype="int8")
    prompts = _prompts(jc.vocab_size, n=2, seed=4)
    _, want = _serve(jengine, jc, jp, prompts, "chunked", new_tokens=4)
    _, got = _serve(tengine, tc, tp, prompts, "chunked", new_tokens=4)
    assert got == want
    kv = tzoo.init_caches(tc, 2, 32, device="cpu")["stack"][0]["kv"]
    assert kv.k.dtype == kv.v.dtype == torch.int8


# ---------------------------------------------------------------------------
# the engine's bookkeeping
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, tick=0.5):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def test_waves_metrics_and_clock():
    _, tc, _, tp = _model("qwen2-1.5b")
    eng = tengine.ServeEngine(tc, tp, batch_size=2, max_len=32,
                              clock=FakeClock(0.5), impl="chunked")
    assert eng.throughput() == {"prefill_tok_per_s": 0.0,
                                "decode_tok_per_s": 0.0}
    new_tokens = [3, 5, 4, 2, 6]
    reqs = [tengine.Request(i, np.arange(1, 6, dtype=np.int32) + i,
                            max_new_tokens=new_tokens[i]) for i in range(5)]
    eng.run(reqs)
    assert [len(r.out_tokens) for r in reqs] == new_tokens
    assert all(r.done for r in reqs)
    assert eng.metrics["prefill_tokens"] == 5 * 5
    # 3 waves, each reading the clock twice per phase: one tick a span
    assert eng.metrics["prefill_s"] == pytest.approx(1.5)
    assert eng.metrics["decode_s"] == pytest.approx(1.5)
    assert eng.metrics["decode_tokens"] == 2 * 4 + 2 * 3 + 1 * 5


def test_prompt_and_new_tokens_must_fit_max_len():
    _, tc, _, tp = _model("qwen2-1.5b")
    eng = tengine.ServeEngine(tc, tp, batch_size=1, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.run([tengine.Request(0, np.arange(1, 6, dtype=np.int32),
                                 max_new_tokens=5)])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [
    dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.6),
    dict(temperature=1.0, top_k=8, top_p=0.9)])
def test_sampling_masks_are_the_references(p, monkeypatch):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    seen = []

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)
    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                     jsampling.SamplingParams(**p))
    got = tsampling.masked_logits(torch.from_numpy(logits),
                                  tsampling.SamplingParams(**p)).numpy()
    np.testing.assert_array_equal(got <= -1e29, seen[0] <= -1e29)
    keep = got > -1e29
    np.testing.assert_allclose(got[keep], seen[0][keep], rtol=1e-6)
    # draws land only where the mask keeps a token
    gen = torch.Generator().manual_seed(3)
    for _ in range(8):
        tok = tsampling.sample(torch.from_numpy(logits), gen,
                               tsampling.SamplingParams(**p))
        assert all(keep[b, int(t)] for b, t in enumerate(tok))


def test_sample_greedy_is_argmax_and_draws_need_a_generator():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 2.9]])
    tok = tsampling.sample(logits, None, tsampling.SamplingParams(greedy=True))
    assert tok.tolist() == [1, 0] and tok.dtype == torch.int32
    with pytest.raises(ValueError):
        tsampling.sample(logits, None, tsampling.SamplingParams())


# ---------------------------------------------------------------------------
# the serving graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", [
    tsampling.SamplingParams(greedy=True),
    tsampling.SamplingParams(temperature=1.0, top_k=20)])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "seamless-m4t-medium"])
def test_serving_graph_at_decode_is_bitwise_the_engine(arch, sampling):
    _, tc, _, tp = _model(arch)
    prompts = _prompts(tc.vocab_size, n=2, seed=7)
    eng, want = _serve(tengine, tc, tp, prompts, "kernel", sampling=sampling,
                       seed=5)
    geng = tengine.ServeEngine(tc, tp, batch_size=2, max_len=24,
                               sampling=sampling)
    graph = tops.serving_graph(geng, prompt_len=8, max_new_tokens=5)
    assert {frozenset(f) for f in graph.frontiers()} == {
        frozenset(), frozenset({"prefill"}), frozenset({"decode"}),
        frozenset({"prefill", "decode"})}
    states = graph.init_states("cpu")
    batch = tops.serve_wave_batch(geng, prompts, seed=5)
    _, out = graph.run(states, batch, frontier={"decode"})
    assert out["out_tokens"].tolist() == want
    assert "kv" not in out and "tok" not in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_costs_equal_the_references(arch):
    for smoke in (True, False):
        jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert tops.param_bytes(tc) == jops.param_bytes(jc)
        for b, t, src in ((2, 32, 0), (8, 1024, 0), (8, 1024, 512)):
            assert tops.kv_cache_bytes(tc, b, t, src) == \
                jops.kv_cache_bytes(jc, b, t, src)
        pb = jops.param_bytes(jc)
        for phase, kw in (("prefill", dict(seq_len=512)),
                          ("decode", dict(seq_len=0, new_tokens=32,
                                          downlink_ok=True)),
                          ("train", dict(seq_len=64))):
            want = jroof.dl_operator_cost(phase, jc, phase=phase, batch=8,
                                          param_bytes=pb, state_bytes=pb,
                                          **kw)
            got = troof.dl_operator_cost(phase, tc, phase=phase, batch=8,
                                         param_bytes=pb, state_bytes=pb, **kw)
            assert got.__dict__ == want.__dict__


def _cluster(cm, edge_mem=4e9, kv_link_bw=2e7):
    """The cluster of examples/edge_serving.py, in either package."""
    edge = cm.Resource("edge0", "edge", chips=1, flops=4e9, mem_bw=5e9,
                       mem_cap=edge_mem, net_bw=1e9)
    cloud = cm.Resource("cloud0", "cloud", chips=1, flops=1e13,
                        mem_bw=2.5e9, mem_cap=64e9, net_bw=100e9)
    return cm.ClusterSpec(
        pools=[edge, cloud],
        links=[cm.Link("edge0", "cloud0", bw=1e9, latency=5e-3),
               cm.Link("cloud0", "edge0", bw=kv_link_bw, latency=5e-3)])


def test_serving_graph_placement_plans_equal_the_references():
    jc, tc, jp, tp = _model("qwen2-1.5b")
    jg = jops.serving_graph(jengine.ServeEngine(jc, jp, batch_size=2,
                                                max_len=32),
                            prompt_len=24, max_new_tokens=4)
    tg = tops.serving_graph(tengine.ServeEngine(tc, tp, batch_size=2,
                                                max_len=32),
                            prompt_len=24, max_new_tokens=4)
    assert [c.__dict__ for c in tg.costs()] == [c.__dict__ for c in jg.costs()]
    split = 0
    for edge_mem in (1e3, 4e9):
        for rate in (1e2, 1e3, 3e3):
            for method in ("dp", "enumerate"):
                jplan, jf = jplace.place_frontier(
                    jg, _cluster(jcm, edge_mem), rate, jplace.Objective(),
                    method=method)
                tplan, tf = tplace.place_frontier(
                    tg, _cluster(tcm, edge_mem), rate, tplace.Objective(),
                    method=method)
                assert tplan.assignment == jplan.assignment
                assert tf == jf
                assert tplan.latency_s == jplan.latency_s
                split += tf == frozenset({"decode"})
    assert split > 0        # the cloud-prefill/edge-decode split occurs


def test_graph_states_default_to_the_card():
    _, tc, _, tp = _model("qwen2-1.5b")
    graph = tops.serving_graph(tengine.ServeEngine(tc, tp), prompt_len=4,
                               max_new_tokens=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graph.init_states()
