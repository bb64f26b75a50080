"""The port's launchers (``python -m repro_torch.launch.serve`` and
``... .train``) on the CPU, against the JAX package's.

``launch.serve``'s ``run`` on parameters converted from the reference's
``init_params(cfg, 0)`` must give the reference ``ServeEngine``'s greedy
tokens on the same ``default_rng(0)`` prompts (a dense, an rwkv6 and a
MoE smoke configuration; rwkv6's reference runs its Pallas kernel in
interpret mode, the port its kernel's plain version). ``launch.train``
mirrors ``tests/test_system.py``'s elastic runs with ``--device cpu``:
each mesh device is a gloo rank the launcher spawns. The elastic run's
final checkpointed params must be within ``rtol`` 2e-3, ``atol`` 2e-4 of
the same run without ``--elastic`` (the reference's sharded-step
bounds), and a ``--resume`` run must continue bitwise from the saved
step.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from repro.configs import get_config as jget
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve.sampling import SamplingParams

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
STEP_TOL = dict(rtol=2e-3, atol=2e-4)
RUN_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# launch.serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,jimpl", [
    ("qwen2-1.5b", "chunked"),
    ("rwkv6-1.6b", "pallas"),
    ("granite-moe-1b-a400m", "chunked"),
])
def test_serve_run_gives_the_reference_engines_tokens(arch, jimpl, capsys,
                                                      monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    args = tserve.parse_args([
        "--arch", arch, "--smoke", "--requests", "3", "--prompt-len", "8",
        "--new-tokens", "4", "--max-len", "16", "--device", "cpu"])
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    jp = jzoo.init_params(jc, 0)
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    done, _ = tserve.run(tc, tp, args)
    out = capsys.readouterr().out.splitlines()

    eng = jengine.ServeEngine(jc, jp, batch_size=args.batch_size,
                              max_len=args.max_len, impl=jimpl,
                              sampling=SamplingParams(greedy=True))
    rng = np.random.default_rng(0)
    reqs = [jengine.Request(i, rng.integers(0, jc.vocab_size,
                                            args.prompt_len).astype(np.int32),
                            max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    eng.run(reqs)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in reqs]
    assert out[0] == f"arch={tc.name} params={jzoo.param_count(jc)/1e6:.1f}M"
    assert out[1] == f"req 0: out={reqs[0].out_tokens[:8]}..."
    assert out[-1].startswith("throughput: {'prefill_tok_per_s': ")


def test_serve_main_draws_its_weights_on_the_device(capsys):
    done, eng = tserve.main(["--arch", "qwen2-1.5b", "--smoke", "--requests",
                             "2", "--new-tokens", "3", "--device", "cpu"])
    assert eng.device.type == "cpu"
    assert [len(r.out_tokens) for r in done] == [3, 3]
    assert "req 1: out=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def _train(*flags, ckpt_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--smoke", "--device", "cpu", "--ckpt-dir",
         str(ckpt_dir), *flags],
        capture_output=True, text=True, env=env, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    return out.stdout


def _arrays(ckpt_dir, step):
    with np.load(pathlib.Path(ckpt_dir) / f"step_{step:010d}" /
                 "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_elastic_train_rescales_through_checkpoint_cycle(tmp_path):
    """``--data-mesh 2 --elastic --elastic-demand 8``: two ranks grow to
    four through the save -> rebuild_mesh -> reshard_tree -> resume
    cycle, and end within the stated tolerance of the same two ranks
    without ``--elastic``."""
    flags = ("--steps", "6", "--batch", "2", "--seq", "16", "--data-mesh",
             "2", "--ckpt-every", "6")
    out = _train(*flags, "--elastic", "--elastic-demand", "8",
                 "--max-workers", "4", ckpt_dir=tmp_path / "el")
    assert "elastic grow -> 4 workers" in out, out
    assert "resumed from checkpoint cycle on a (4, 1) mesh" in out
    assert "rescales=1" in out
    plain = _train(*flags, ckpt_dir=tmp_path / "plain")
    assert "elastic grow" not in plain and "(latest 6, rescales=0)" in plain
    got, want = _arrays(tmp_path / "el", 6), _arrays(tmp_path / "plain", 6)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)
    # the cycle left its own checkpoint behind
    steps = sorted(p.name for p in (tmp_path / "el").iterdir())
    assert len(steps) == 2 and steps[-1] == "step_0000000006"


def test_elastic_without_demand_grows_on_queue_backlog(tmp_path):
    """No demand curve: the stream feeder's full prefetch queue is the
    offered load, and the pool grows to ``--max-workers`` ranks."""
    out = _train("--steps", "8", "--batch", "2", "--seq", "16",
                 "--data-mesh", "1", "--elastic", "--max-workers", "2",
                 "--ckpt-every", "50", ckpt_dir=tmp_path)
    assert "elastic grow -> 2 workers" in out, out
    assert "resumed from checkpoint cycle on a (2, 1) mesh" in out


def test_resume_continues_bitwise_from_the_saved_step(tmp_path):
    """A (2, 2) ``tp_fsdp`` run of 6 steps checkpoints at 3 and 6; a run
    resumed from its step 3 alone saves a step 6 equal to it, bit for
    bit."""
    flags = ("--steps", "6", "--batch", "4", "--seq", "16", "--recipe",
             "tp_fsdp", "--data-mesh", "2", "--model-mesh", "2",
             "--ckpt-every", "3")
    _train(*flags, ckpt_dir=tmp_path / "whole")
    (tmp_path / "resumed").mkdir()
    shutil.copytree(tmp_path / "whole" / "step_0000000003",
                    tmp_path / "resumed" / "step_0000000003")
    out = _train(*flags, "--resume", ckpt_dir=tmp_path / "resumed")
    assert "resumed from step 3" in out
    got, want = _arrays(tmp_path / "resumed", 6), _arrays(tmp_path / "whole", 6)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not all(np.array_equal(want[k], _arrays(tmp_path / "whole", 3)[k])
                   for k in want)
