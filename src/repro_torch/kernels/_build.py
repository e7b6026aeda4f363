"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<source>.cu`` exposes a plain C interface (one
or more entry points, :data:`SIGNATURES`) and is compiled on first use, on
the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <repo>/build/repro_torch_kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``, e.g. ``tma.cuh``), so an edited kernel is rebuilt and
never confused with a stale one.  Only sources in this
checkout are compiled; nothing is fetched.  :func:`build_all` starts one
``nvcc`` per source at once (a cold start builds every kernel in the time
of the slowest).  Pointer and stream arguments are ``c_void_p`` and every
entry point returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.

Every kernel has a hand-written backward (``flash_attention_bwd.cu``,
``moe_gmm_bwd_launch`` in ``moe_gmm.cu``, ``ssm_scan_bwd_launch`` in
``ssm_scan.cu``), which its wrapper's ``torch.autograd.Function``
launches.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: C entry points: name → (source, entry point, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "moe_gmm": ("moe_gmm", "moe_gmm_launch",
                [_P] * 7 + [_I] * 8 + [_P]),
    "moe_gmm_bwd": ("moe_gmm", "moe_gmm_bwd_launch",
                    [_P] * 12 + [_I] * 5 + [_P]),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [_P] * 5 + [_I] * 9 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_launch",
                            [_P] * 10 + [_I] * 9 + [_P]),
    "ssm_scan": ("ssm_scan", "ssm_scan_launch",
                 [_P] * 6 + [_I] * 4 + [_P]),
    "ssm_scan_bwd": ("ssm_scan", "ssm_scan_bwd_launch",
                     [_P] * 11 + [_I] * 4 + [_P]),
}
#: the sources, one library (and one ``nvcc``) each
SOURCES = tuple(sorted({src for src, _, _ in SIGNATURES.values()}))

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
    digest = hashlib.sha1()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


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
    """Compile every source (of ``names``, default all) not built yet, one
    ``nvcc`` per source, all started together.  Returns the build logs."""
    names = list(names or SOURCES)
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        for n, s in started.items():
            _finish(n, s)
    return dict(build_log)


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use), its entry
    points typed."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all([source])
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(_target(source)))
            for src, fn_name, argtypes in SIGNATURES.values():
                if src == source:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[source] = lib
    return _libs[source]


def entry(name: str):
    """The C entry point ``name`` of :data:`SIGNATURES`."""
    source, fn_name, _ = SIGNATURES[name]
    return getattr(library(source), fn_name)


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


def needs_grad(*tensors) -> bool:
    """Grad mode is on and an input requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def all_on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU — the one case in which a
    wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)
