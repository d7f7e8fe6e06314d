"""Build and bind the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, which `ctypes` loads. All sources are
compiled at first use, one `nvcc` process per source, started together. A
library is named by a hash of its source, every header of `csrc/` and the flags,
so an edited source is rebuilt and an unchanged one is reused from
`vstab_torch/_build/`.

No source includes PyTorch's headers: `torch.utils.cpp_extension.load`
needs minutes for one file that does, `nvcc` seconds for a file that does
not. Each C entry point returns `cudaGetLastError()` right after its
launch, and `CudaKernel.__call__` raises when that is not 0.

Nothing here runs at import: the modules that hold the wrappers import
this one on machines with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = ("cost_volume", "warp", "warp1d", "corr_lookup")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use"
    )


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every source of `names` whose library is missing, all in
    parallel; returns the seconds spent. Raises with nvcc's output if any
    compile fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        target = _library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            path = _library_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            lib.vstab_error_string.argtypes = [ctypes.c_int]
            lib.vstab_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


class CudaKernel:
    """One C entry point of a built library and the count of its launches.

    `launches` goes up by one for every launch that the CUDA runtime
    accepted, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = library(self.source).vstab_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA launch failed ({err}: {msg})")
        self.launches += 1


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, tensors: Dict[str, torch.Tensor], dtypes) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    `dtypes`, all on one device: the kernels take nothing else."""
    dev = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel needs CUDA")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, the kernel takes {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: inputs lie on {dev} and {t.device}")


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda's graph API."""

    _fields_ = [
        ("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
        ("shared_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
        ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
    ]


def graph_nodes(run) -> list:
    """The device work of one call of `run`, exactly: a CUDA-graph capture of
    the call, with nothing run, and one dict a node of the graph: "type"
    (CUgraphNodeType: 0 a kernel, 1 a copy, 2 a memset, ...);
    for a kernel also "grid", "block", "shared_bytes" and "name", the
    kernel's (mangled) name where libcuda gives it (CUDA 12.3 and later),
    else None. `run` is called once first, so that what it sets up once
    stays out. Needs a CUDA device; the port itself never calls it."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err):
        if err:
            raise RuntimeError(f"libcuda call failed ({err})")

    def name_of(p):
        name = ctypes.c_char_p()
        for handle, getter in ((p.func, "cuFuncGetName"), (p.kern, "cuKernelGetName")):
            if handle and hasattr(cu, getter) and getattr(cu, getter)(ctypes.byref(name), ctypes.c_void_p(handle)) == 0:
                return name.value.decode()
        return None

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        run()
    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)))
    handles = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, handles, ctypes.byref(count)))
    nodes = []
    for handle in handles:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(handle), ctypes.byref(kind)))
        node = {"type": kind.value}
        if kind.value == 0:
            p = _KernelNodeParams()
            check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(handle), ctypes.byref(p)))
            node.update(grid=tuple(p.grid), block=tuple(p.block), shared_bytes=p.shared_bytes, name=name_of(p))
        nodes.append(node)
    del graph
    return nodes


__all__ = [
    "BUILD_DIR",
    "SOURCES",
    "CudaKernel",
    "build_all",
    "check_cuda",
    "graph_nodes",
    "library",
    "stream_ptr",
]
