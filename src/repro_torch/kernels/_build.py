"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled on first use, on the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <repo>/build/repro_torch_kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the source, so an edited kernel is
rebuilt and never confused with a stale one.  Only sources in this
checkout are compiled; nothing is fetched.  :func:`build_all` starts one
``nvcc`` per source at once (a cold start builds every kernel in the time
of the slowest).  Pointer and stream arguments are ``c_void_p`` and every
entry point returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: C signatures: name → (entry point, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "moe_gmm": ("moe_gmm_launch",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per
#: kernel, kept for the chip smoke to print
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME)")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together.  Returns the build logs."""
    names = list(names or SIGNATURES)
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        for n, s in started.items():
            _finish(n, s)
    return dict(build_log)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def entry(name: str):
    return getattr(library(name), SIGNATURES[name][0])


def check(name: str, code: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def cuda_inputs(name: str, *tensors) -> int:
    """Validate the tensors a CUDA kernel is about to be given — one CUDA
    device, one dtype (fp32 or bf16), contiguous — and return the
    kernel's dtype code.  Raises on anything the kernel does not take;
    there is no fallback."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes "
                            f"{[str(x.dtype) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    code = DTYPE_CODES.get(str(dt))
    if code is None:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"not {dt}")
    return code


def all_on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU — the one case in which a
    wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)
