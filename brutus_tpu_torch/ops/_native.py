"""
Build, load and launch the port's hand-written CUDA kernels.

All sources under `brutus_tpu_torch/csrc/` have a plain `extern "C"`
interface and include no PyTorch header, so ONE `nvcc` call compiles
them for `sm_90a` into a shared library in seconds.  The library is
built at first use into `build/kernels/` beside the package (listed in
`.gitignore`), named by a hash of the sources and flags so an edited
source is never served a stale build, and loaded with `ctypes`.

Every launch goes through a `Kernel`: it passes tensor pointers and the
current CUDA stream as `c_void_p`, raises if the C entry returns a CUDA
error (a refused launch never runs and a later synchronise would not
report it), and counts its launches; while a profiler records, it
also notes each launch's time in the open `fit` call's record
(`profiling.kernel_launch`).  Importing this module builds nothing: the
wrappers in `funnel.py`, `fit.py`, `mc.py` and `rng.py` call a `Kernel`
(and so build and load the library) only for CUDA tensors.  Every
kernel's `__global__` function has one of `screen_kernel`,
`gather_kernel`, `fit_kernel` or `mc_kernel` in its name: the
benchmark's traced runs pair the launches noted here with the trace's
kernels by those names (`gpubench/tracing.py`).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .. import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)),
                         "build", "kernels")
# -fmad=false: no multiply-add contraction, so every float operation
# rounds as the plain PyTorch versions round it (kernels write `fmaf`
# where they want one).  The fit kernel's fixed iteration budget
# branches on float comparisons (freeze, clamps, step damping): with
# contraction, over all 750k models of a grid, enough of them flipped
# against the plain version to move fits by a nat; without it the
# kernel matches its plain version bit for bit on an H100.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build():
    """Compile every kernel source with one nvcc call (skipped when a
    build of the same sources exists); returns `(path, log)`."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"libbrutus_kernels_{h.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        with open(log_path) as f:
            return path, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path, log


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            lib.bk_error_string.restype = ctypes.c_char_p
            lib.bk_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint


class Kernel:
    """One hand-written CUDA kernel behind a C entry point.

    `launches` counts the launches made through `__call__`, and only
    those: it is how a run shows that its path went through the kernel.
    """

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(self.argtypes) + [P]      # + stream
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]          # None passes a null pointer
        profiling.kernel_launch(self.name)
        err = self._fn(*conv, stream)
        if err != 0:
            msg = library().bk_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed: {msg}")
        self.launches += 1


KERNELS = {
    "screen": Kernel(
        "screen", "bk_screen",
        [P, P, P, P, P, P, I, I, I, I],
        "brutus_tpu_torch/csrc/screen.cu",
        "brutus_tpu/ops/pallas_loglike.py:452"),
    "gather": Kernel(
        "gather", "bk_gather",
        [P, P, P, I, I, I, I, I],
        "brutus_tpu_torch/csrc/gather.cu",
        "brutus_tpu/ops/pallas_loglike.py:1049"),
    "fit": Kernel(
        "fit", "bk_fit",
        [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I],
        "brutus_tpu_torch/csrc/fit.cu",
        "brutus_tpu/ops/pallas_loglike.py:66"),
    "fit_dense": Kernel(
        "fit_dense", "bk_fit_dense",
        [P, P, P, P, P, I, I, I, I, I, I, I, I],
        "brutus_tpu_torch/csrc/fit.cu",
        "brutus_tpu/ops/pallas_loglike.py:66"),
    # K4's two modes share one C entry (`z` or `seeds`) and keep one
    # count each, so a run shows which mode ran.
    "mc_fed": Kernel(
        "mc_fed", "bk_mc",
        [P] * 14 + [I] * 8,
        "brutus_tpu_torch/csrc/mc.cu",
        "brutus_tpu/ops/pallas_mc.py:101"),
    "mc_rng": Kernel(
        "mc_rng", "bk_mc",
        [P] * 14 + [I] * 8,
        "brutus_tpu_torch/csrc/mc.cu",
        "brutus_tpu/ops/pallas_mc.py:101"),
    # The posterior's draws (`rng.draws`): none of the TPU's kernels, as
    # the JAX package draws with `jax.random` in XLA; bound by its stores
    # (~51 KB a funnel star, ~1.28 MB a dense star) and, without
    # normals, by its Philox rounds.
    "draws": Kernel(
        "draws", "bk_draws",
        [P] * 5 + [U] * 2 + [I] * 6,
        "brutus_tpu_torch/csrc/draws.cu",
        "none (jax.random in XLA, brutus_tpu/fitting.py:994, 1017)"),
}


def attributes(symbol, *args):
    """`[registers, local-memory bytes per thread, ...]` of the kernel
    instance that the C entry `symbol` (`bk_fit_attrs`,
    `bk_screen_attrs`) picks for the integer `args` (the filter count
    first), read with `cudaFuncGetAttributes`."""
    fn = getattr(library(), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [I] * len(args) + [P]
    out = (ctypes.c_int * 4)()
    err = fn(*args, out)
    if err != 0:
        msg = library().bk_error_string(err).decode()
        raise RuntimeError(f"{symbol} failed: {msg}")
    return list(out)


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def check(t, name, shape=None, dtype=torch.float32, device=None):
    """Validate a kernel operand: dtype, contiguity, device, shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t


__all__ = ["KERNELS", "Kernel", "build", "library", "attributes",
           "reset_launches", "check"]
