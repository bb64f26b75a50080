"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with :mod:`ctypes`. The
build runs at first use, from the sources in the checkout, into
``kernels/build/`` beside this file (or ``$REPRO_TORCH_BUILD_DIR``); the
library name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3`` and no fast math for every source.
The sources in :data:`EXACT` add ``-fmad=false``, so no multiply-add is
contracted: they repeat their plain versions' roundings operation by
operation and are held to them bitwise or within an ulp. The others
(attention and the WKV and Mamba scans, held to a float tolerance, and
the integer-only count-min and Misra-Gries kernels) keep nvcc's default
of fused multiply-adds. ``-Xptxas -v`` writes each kernel's
registers and shared memory into ``<name>.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("ef_codec", "preprocess", "detector_scan", "flash_attention",
           "rwkv6_wkv", "countmin", "mg_scan", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXACT = ("ef_codec", "preprocess", "detector_scan")


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + (("-fmad=false",) if name in EXACT else ())


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(d) if d else pathlib.Path(__file__).resolve().parent / "build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the port's "
                       "CUDA kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: library path}``;
    raises with the compiler's output if any build fails."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_name(f".{out[n].name}.{os.getpid()}.tmp")
        log = open(d / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [exe, *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[n])
        else:
            failed.append(n)
    if failed:
        msgs = [f"--- {n} ---\n" + (d / f"{n}.log").read_text()
                for n in failed]
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(msgs))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


def device_stats(store: dict, device, size: int = 2) -> "torch.Tensor":
    """The int64 (``size``,) counters on ``device`` that a kernel adds to
    at each launch (``store`` maps each device to its tensor), made at
    first use."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in store:
        store[dev] = torch.zeros(size, dtype=torch.int64, device=dev)
    return store[dev]


def refuse_autograd(what: str, *tensors) -> None:
    """Raise ``RuntimeError`` where grad mode is on and a tensor (or a
    tensor field of a NamedTuple state) requires grad: a ``ctypes``
    launch is invisible to autograd, so the gradient through it would
    come back as silently zero. No kernel of the port has a backward;
    training takes the plain chunked paths (``impl="chunked"``)."""
    import torch
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        parts = t if isinstance(t, tuple) else (t,)
        if any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in parts):
            raise RuntimeError(
                f"{what}: an input requires grad, and the CUDA kernel has "
                "no backward (autograd cannot see its launch); train "
                "through impl='chunked', or call it under torch.no_grad()")


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
