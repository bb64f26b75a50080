"""The port's checkpointing (``repro_torch.dist.checkpoint``) on the CPU:
the JAX package's ``tests/test_checkpoint.py`` for the asynchronous
writer, a snapshot that an in-place update after ``save`` does not
change, bf16 leaves widened on disk and cast back, a writer's error
surfaced on ``wait``, and a training run resumed bitwise from an async
checkpoint (``chip_smoke.py`` phase 12 repeats the last on the card)."""

import time

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models import model_zoo as zoo
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(
                       np.float32)),
                   "layers": [torch.ones((3,)), torch.zeros((2, 2))]},
        "opt": {"m": torch.full((8, 4), 0.5)},
    }


def _equal(a, b):
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_async_checkpointer_nonblocking(tmp_path):
    t = tree_map(lambda x: x.repeat(64, 1) if x.dim() == 2 else x, _tree())
    ac = ckpt.AsyncCheckpointer(tmp_path)
    t0 = time.perf_counter()
    ac.save(100, t)
    submit_time = time.perf_counter() - t0
    ac.wait()
    assert submit_time < 5.0
    assert ckpt.latest_step(tmp_path) == 100
    restored, _ = ckpt.restore(tmp_path, t)
    _equal(t, restored)
    ac.close()


def test_snapshot_is_not_changed_by_an_update_after_save(tmp_path):
    """``save`` returns with the tree copied to host memory: the port's
    optimizers overwrite the tensors in place right after it."""
    t = _tree()
    want = tree_map(torch.clone, t)
    with ckpt.AsyncCheckpointer(tmp_path) as ac:
        ac.save(1, t, meta={"loss": 2.5})
        for x in tree_leaves(t):
            x.add_(1.0)
        ac.wait()
    restored, meta = ckpt.restore(tmp_path, t)
    _equal(want, restored)
    assert meta == {"step": 1, "meta": {"loss": 2.5}}


def test_bf16_leaves_are_widened_on_disk_and_cast_back(tmp_path):
    t = {"p": torch.randn(5, 3).bfloat16(), "n": torch.arange(4),
         "f": torch.randn(2)}
    with ckpt.AsyncCheckpointer(tmp_path) as ac:
        ac.save(7, t)
    with np.load(tmp_path / "step_0000000007" / "arrays.npz") as z:
        assert z["['p']"].dtype == np.float32
    restored, _ = ckpt.restore(tmp_path, t)
    _equal(t, restored)


def test_writer_error_surfaces_on_wait_and_close_refuses_saves(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ac = ckpt.AsyncCheckpointer(blocker)
    ac.save(1, _tree())
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()       # the error is reported once
    ac.close()
    with pytest.raises(RuntimeError, match="closed"):
        ac.save(2, _tree())


def test_async_keep_retention(tmp_path):
    with ckpt.AsyncCheckpointer(tmp_path, keep=2) as ac:
        for s in range(5):
            ac.save(s, {"w": torch.full((2,), float(s))})
    assert ckpt.latest_step(tmp_path) == 4
    steps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert len(steps) == 2
    restored, _ = ckpt.restore(tmp_path, {"w": torch.zeros(2)})
    assert torch.equal(restored["w"], torch.full((2,), 4.0))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_training_resumes_bitwise_from_an_async_checkpoint(tmp_path,
                                                           param_dtype):
    """6 AdamW steps uninterrupted, against 6 steps with a save after
    step 3 (the next step updates the tensors in place as soon as it
    returns) and a second run restored from that save into fresh state:
    parameters and moments bitwise."""
    from dataclasses import replace
    cfg = replace(get_config("qwen2-1.5b", smoke=True),
                  param_dtype=param_dtype, compute_dtype=param_dtype)
    opt = make_optimizer(cfg, "adamw", lr=3e-3, total_steps=6, warmup=2)
    step_fn = make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))} for _ in range(6)]

    def run(params, state, start, stop, saver=None):
        step = torch.tensor(start, dtype=torch.int32)
        for i in range(start, stop):
            params, state, step, _ = step_fn(params, state, step, batches[i])
            if saver is not None and i + 1 == 3:
                saver.save(int(step), {"params": params, "opt": state})
        return params, state

    p = zoo.init_params(cfg, 0, device="cpu")
    with ckpt.AsyncCheckpointer(tmp_path) as saver:
        p_end, s_end = run(p, opt.init(p), 0, 6, saver)
    fresh = zoo.init_params(cfg, 1, device="cpu")
    tree, meta = ckpt.restore(tmp_path, {"params": fresh,
                                         "opt": opt.init(fresh)})
    assert meta["step"] == 3
    r_end, rs_end = run(tree["params"], tree["opt"], 3, 6)
    _equal({"p": p_end, "s": s_end}, {"p": r_end, "s": rs_end})
    if param_dtype == "bfloat16":
        assert "master" in s_end
