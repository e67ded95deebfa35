"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` into one shared library with a plain
C interface, loaded through ``ctypes``: one ``nvcc -c`` per source, all
started together, then one link. The build runs on first use, from the
sources in the package only, into ``build/torch_kernels/`` at the
repository root (listed in ``.gitignore``); the library's file name
carries a hash of the sources, so an edited kernel is rebuilt and a
stale library is never loaded. Besides the four kernels of the pipeline
it holds an empty kernel (``noop``), whose time in a CUDA graph is the
launch floor the kernels are read against, and the two entry points
that capture a CUDA-graph conditional node (``if_begin`` / ``if_end``,
``csrc/cond.cu``; ``models/conditional.py`` uses them), and the tracing's
one-thread stamp of the card's clock (``stamp``, ``csrc/stamp.cu``;
``ops/launches.py`` holds its ring). K1's and K3's entry points
take a lane count: B lanes in one launch (1 for the single-lane call).

Flags: ``-fmad=false`` keeps ``a*b + c`` as a separate multiply and add,
so squared distances round exactly as the plain PyTorch versions (one
elementwise op per kernel launch) round them, and argmin indices agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every kernel entry point: (argtypes), all return int
# (the cudaError_t of the launch).
_SIGNATURES = {
    "loam_grid_windows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "loam_greedy_pick_rows": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _F, _I, _I, _I, _P],
    "loam_corresp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _F, _I, _P],
    "loam_grouped_window_knn": [_P, _P, _P, _P, _I, _I, _I, _P],
    "loam_noop": [_P],
    "loam_if_begin": [_P, _P, _P],
    "loam_if_end": [ctypes.POINTER(ctypes.c_size_t), _P],
    "loam_stamp": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
}

_lib = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libloam_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if not built yet) and return the library path."""
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = tmp.with_suffix(".obj")
    objs.mkdir(parents=True, exist_ok=True)
    try:
        jobs = [(src, objs / f"{src.stem}.o") for src in sources()]
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in jobs]
        logs = [p.communicate()[1] for p in procs]
        failed = [(src.name, p.returncode, log) for (src, _), p, log
                  in zip(jobs, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *(str(obj) for _, obj in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    if verbose:
        print("\n".join(log.strip() for log in logs))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call one kernel entry point on ``device``'s current stream; raise
    if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def noop(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream (the
    launch floor; it counts nothing)."""
    launch("loam_noop", device)


def stamp(ring: torch.Tensor, cursor: torch.Tensor, code: int) -> None:
    """Launch the stamp on the current stream of ``ring``'s card: the
    card's clock and ``code`` into ``ring`` ((capacity, 2) int64) at the
    slot the cursor (a one-element int64 on the card) points to. In a
    capture it becomes a node of the graph."""
    launch("loam_stamp", ring.device, ring.data_ptr(), cursor.data_ptr(),
           ring.shape[0], code)


def if_begin(pred: torch.Tensor, body, stream) -> None:
    """Inside a capture on ``stream``: an IF node on the card's bool
    ``pred`` (0-d), whose body is captured on the stream ``body`` from
    now until ``if_end(body)``."""
    err = lib().loam_if_begin(pred.data_ptr(), body.cuda_stream,
                              stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"loam_if_begin: CUDA error {err}: the conditional "
                           "node could not be captured")


def if_end(body) -> int:
    """End the capture of the body begun by ``if_begin``; returns the
    body's node count."""
    nodes = ctypes.c_size_t(0)
    err = lib().loam_if_end(ctypes.byref(nodes), body.cuda_stream)
    if err != 0:
        raise RuntimeError(f"loam_if_end: CUDA error {err}: the conditional "
                           "node's body could not be captured")
    return nodes.value


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrapper guard: every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor not contiguous")
