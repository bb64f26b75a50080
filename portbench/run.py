"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each compared number beside
its limit, also the last lines of standard error). Exits 2 without a
result where no card is visible, 3 where JAX or the JAX package was
loaded. The kernel and compiler caches live in the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".portbench_cache"


def main(argv=None) -> int:
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        CHECKOUT / "src" / "repro_torch" / "kernels" / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from portbench import bench
    return bench.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
