"""Build-on-first-use loader for the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain
C interface, loaded with ``ctypes`` (modelled on the JAX package's
``native.py`` loader for ``native/gtop_core.cpp``).  The library name
carries a hash of the sources and flags, so an edit to any kernel
rebuilds it; builds go to ``build/cuda/`` at the repository root, which
``.gitignore`` lists.  Nothing is built or loaded at import: the first
CUDA tensor that reaches a kernel wrapper triggers :func:`load`.

There is no fallback.  Without ``nvcc`` or a visible GPU, :func:`load`
raises; the wrappers take their plain PyTorch versions only for tensors
that lie on the CPU.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.  Pointers and the stream pass as
``ctypes.c_void_p``.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")

#: No --use_fast_math: expf, sqrtf and the divisions stay IEEE, which the
#: parity with the plain versions relies on.  -Xptxas -v writes each
#: kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
_lock = threading.Lock()

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong

#: C signatures of the entry points (restype int = cudaError_t unless
#: _RESTYPES says otherwise)
_SIGNATURES = {
    "gto_minplus_axis": [_vp, _vp, _i64, _i32, _i64, _vp],
    # f, out, scratch (null when gto_minplus_long_scratch is 0), uint64
    # counts[4], O, n, I, stream
    "gto_minplus_long": [_vp, _vp, _vp, _vp, _i64, _i32, _i64, _vp],
    # n, lines -> bytes of scratch (restype int64)
    "gto_minplus_long_scratch": [_i32, _i64],
    "gto_trilinear_batch": [
        _vp, _i64, _i32, _i32, _i32, _vp, _vp, _vp, _i32, _i32, _vp, _vp,
        _vp,
    ],
    "gto_descend": [
        _vp, _i64, _i32, _i32, _i32,          # grids, stride, nx, ny, nz
        _vp, _vp, _vp, _vp,                   # cpos cvel cacc ccols
        _vp, _vp, _vp, _vp, _vp,              # rpp cgt lb ub dp0
        _vp, _vp, _vp,                        # dts dfT misc
        _i32, _i32, _i32, _i32,               # B, SP, m, K
        _vp, _vp,                             # host float / int params
        _vp, _vp, _vp, _vp,                   # odp ocost onacc otrace
        _vp,                                  # stream
    ],
    # m, K, window, use_a, B, int out[5]
    "gto_descend_plan": [_i32, _i32, _i32, _i32, _i32, _vp],
    # int out[5]: kMaxSmem, sizeof(GtoFrame), registers, maxThreadsPerBlock,
    # largest resident block
    "gto_descend_limits": [_vp],
    # res, first bit pattern, count, uint64 out[257], stream
    "gto_div_check": [ctypes.c_float, _i64, _i64, _vp, _vp],
}


_RESTYPES = {"gto_minplus_long_scratch": _i64}


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def source_hash() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libgto_kernels-{source_hash()}.so")


def build_log() -> str:
    """nvcc's output for the current library (empty before a build)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def nvcc_path() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.insert(0, os.path.join(cuda_home, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built on this host"
    )


def _compile(out_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out_path + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out_path)  # atomic: concurrent builders race safely


def open_library(path: str, names=None):
    """Load a kernel library built from these sources (or a variant of
    them) and declare the C signatures of ``names`` (default: all)."""
    lib = ctypes.CDLL(path)
    for name in _SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.gto_error_string.argtypes = [ctypes.c_int]
    lib.gto_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port's CUDA kernels need an NVIDIA GPU; none is visible"
            )
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        _lib = open_library(path)
        return _lib


@contextlib.contextmanager
def using(lib):
    """Within the block, :func:`load` returns ``lib`` (a library from
    :func:`open_library`, e.g. a variant of the sources) instead of the
    one built from them; the previous library is restored after."""
    global _lib
    with _lock:
        prev, _lib = _lib, lib
    try:
        yield lib
    finally:
        with _lock:
            _lib = prev


def check(lib, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.gto_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda_f32(name: str, t: torch.Tensor, shape=None,
                     device=None) -> None:
    """Validate a kernel operand: CUDA, float32, contiguous, and
    ``shape`` (None entries match anything) on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and (
        t.dim() != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
