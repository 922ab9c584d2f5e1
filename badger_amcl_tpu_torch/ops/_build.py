"""Build and load the port's CUDA kernels.

`csrc/*.cu` compile at first use with nvcc into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), cached
under `badger_amcl_tpu_torch/_build/` by a hash of the sources and flags,
and loaded with ctypes. Every entry point takes raw device pointers and a
CUDA stream (all `c_void_p`) and returns `cudaGetLastError()` after its
launch; `check` raises on a nonzero code. The first `lib()`, and each
entry point's first call, is a `library.load` region of
`utils.profiling` (timed always; the build a `library.build` span under a
profiler): under CUDA's lazy module loading, the default, an entry
point's first call is what loads its kernels onto the card.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from badger_amcl_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


class BeamConsts(ctypes.Structure):
    """beam_table.cu's BeamConsts: the beam mixture's f32 constants, the yaw
    bin width and bin_inv, passed to the launch by pointer."""

    _fields_ = [(name, _F) for name in ("z_hit", "z_short", "z_max", "z_rand_mult",
                                        "range_max", "denom_inv", "lam", "res", "dtheta",
                                        "bin_inv")]


# argtypes of every C entry point in csrc/
_SIGNATURES = {
    "corr_table_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fleet_corr_table_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "corr_table_q_launch": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "spread_prep_launch": [_P, _I, _P, _P, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P,
                           _P, _P],
    "spread_term_sums_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    "lf_distances_f32_launch": [_P, _P, _I, _P, _P, _I, _F, _F, _F, _I, _I, _I, _I, _F,
                                _P, _P],
    "lf_distances_bf16_launch": [_P, _P, _I, _P, _P, _I, _F, _F, _F, _I, _I, _I, _I, _F,
                                 _P, _P],
    "lf_term_sums_f32_launch": [_P, _P, _I, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I, _I,
                                _F, _I, _F, _F, _F, _P, _P],
    "lf_term_sums_bf16_launch": [_P, _P, _I, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I, _I,
                                 _F, _I, _F, _F, _F, _P, _P],
    "lf_extents_launch": [_P, _I, _P, _P, _I, _F, _F, _F, _I, _I, _I, _I, _P, _P],
    "lf_obs_counts_f32_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I,
                                 _I, _F, _P, _P],
    "lf_obs_counts_bf16_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I,
                                  _I, _F, _P, _P],
    "pc_distances_launch": [_P, _I, _I, _I, _P, _I, _P, _I, _F, _I, _I, _I, _F, _F,
                            _P, _P],
    "pc_extents_launch": [_P, _I, _P, _I, _I, _I, _F, _I, _I, _P, _P],
    "pc_term_sums_launch": [_P, _I, _I, _I, _P, _I, _P, _I, _F, _I, _I, _I, _P, _P, _P],
    "pc_spread_term_sums_launch": [_P, _I, _I, _I, _P, _I, _P, _I, _F, _I, _I, _I,
                                   _P, _P, _P, _P],
    "beam_table_launch": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                          ctypes.POINTER(BeamConsts), _P, _I, _P, _I, _I, _P],
    "beam_spread_sums_launch": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P],
    "edt_2d_launch": [_P, _I, _I, _I, _D, _D, _P, _P, _P],
    "edt_3d_launch": [_P, _I, _I, _I, _I, _D, _D, _P, _P, _P, _P],
    "cluster_labels_launch": [_P, _I, _I, _I, _I, _P, _P, _P],
    "graph_if_begin": [_P, _P, _P],
    "graph_if_end": [_P, _P],
    "graph_while_begin": [_P, _P, _P, _P],
    "graph_while_end": [_P, ctypes.c_ulonglong, _P, _P],
    "graph_capture_nodes": [_P, _P],
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into BUILD_DIR (cached by content); return the path.
    One nvcc per source, all started together, then one link."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libamcl_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    with profiling.span("library.build"):
        _compile(srcs, out, h.hexdigest()[:16], verbose)
    return out


def _compile(srcs: list, out: Path, digest: str, verbose: bool) -> None:
    """nvcc: each source to an object, all started together, then the
    link into `out`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if verbose:
        compile_flags += ["-Xptxas", "-v"]
    objs, procs = [], []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, "-c", "-o", str(obj), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = []
    for s, p in zip(srcs, procs):
        err = p.communicate()[1]
        logs.append((s.name, p.returncode, err))
    failed = [(n, rc, err) for n, rc, err in logs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{n} ({rc}):\n{err}" for n, rc, err in failed))
    if verbose:
        for _, _, err in logs:
            print(err, end="")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


class _Library:
    """The loaded library's entry points, as attributes. Each one's first
    call is a `library.load` region, after which the attribute is the bare
    ctypes function."""

    def __init__(self, handle: ctypes.CDLL):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, self._first_call(name, fn))

    def _first_call(self, name: str, fn):
        def first(*args):
            if getattr(self, name) is not first:  # called again through a held reference
                return fn(*args)
            setattr(self, name, fn)
            with profiling.library(name):
                return fn(*args)

        return first


def lib() -> _Library:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with profiling.library():
            _lib = _Library(ctypes.CDLL(str(build())))
    return _lib


def check(code: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    """The raw pointer of the current CUDA stream of `device`, read without
    building a torch Stream object."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
