"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library (``VARIANTS`` compile one source more than once, with
defines) with a plain C interface, loaded with ``ctypes``.  Builds
happen on first use (never at import: the CPU-only test hosts have no
``nvcc``), go to ``build/repro_torch/<hash>/`` at the repository root --
keyed by a hash of the sources and flags -- one ``nvcc`` process per
library, all started together.  :func:`start` starts them without waiting
(a caller can build the libraries it needs first and let the others
compile behind its work); :func:`build` waits for them; a library's first
use builds and loads that library alone.  A missing ``nvcc`` or a failed
compile raises; there is no fallback.

Kernel wrappers bind their entry points with :func:`bind`, which sets
``argtypes`` (``c_void_p`` for pointers and the stream, ``c_int`` for ints:
without them ctypes would cut 64-bit pointers) and returns a callable that
raises on a nonzero ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Libraries compiled from a shared source with their own defines: the
#: tensor-core K2 over the dense weight store, one library per w_bits, so
#: that the three compile in parallel.
VARIANTS = {f"ulppack_matmul_mma_w{b}": ("ulppack_matmul_mma_dense",
                                         (f"-DDENSE_W_BITS={b}",))
            for b in (1, 2, 4)}
#: ... and the tensor-core K2 of every layout but int16xP2s8, one library
#: per layout (lane bytes, fields, shift): ``layout_library(spec)``.
LAYOUT_VARIANTS = {
    f"ulppack_matmul_mma_{lane}xP{n}s{s}": (
        "ulppack_matmul_mma_lanes",
        (f"-DLANE_BYTES={lb}", f"-DN_PACK={n}", f"-DSHIFT={s}"))
    for lane, lb, n, s in (("int8", 1, 2, 4), ("int16", 2, 4, 4),
                           ("int32", 4, 2, 8), ("int32", 4, 4, 8),
                           ("int32", 4, 2, 16))}
#: ... and K3 and K4 (``csrc/attention_decode.cu``), one library per entry
#: point, so that the two halves of its 50 kernels compile in parallel.
ATTENTION_VARIANTS = {"attention_decode": ("attention_decode",
                                           ("-DATTN_PAGED=0",)),
                      "attention_decode_paged": ("attention_decode",
                                                 ("-DATTN_PAGED=1",))}
#: library -> (source, defines) of every library not built from its own
#: source alone
DEFINES = {**VARIANTS, **LAYOUT_VARIANTS, **ATTENTION_VARIANTS}
SOURCES = ("quant_pack", "ulppack_matmul", *ATTENTION_VARIANTS,
           "ulppack_conv2d", "int_conv2d", "int_matmul",
           "ulppack_matmul_mma", "ulppack_conv2d_mma", "int_conv2d_mma",
           "cache_write", *VARIANTS, *LAYOUT_VARIANTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc processes started and not yet waited for: name -> (the .so they
#: write, the process)
_running: dict[str, tuple[Path, subprocess.Popen]] = {}
_running_lock = threading.RLock()
_started: dict[str, float] = {}
#: Seconds from each library's nvcc start to its output's last write, for
#: the libraries this process built.
seconds: dict[str, float] = {}


def build_root() -> Path:
    """``build/repro_torch`` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch "
            "CUDA kernels are compiled on first use and need the CUDA "
            "toolkit; CPU tensors use the plain PyTorch versions instead")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(DEFINES.items())).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_dir() -> Path:
    return build_root() / _source_hash()


def start(names=SOURCES, *, nice: int = 0) -> list[str]:
    """Start one ``nvcc`` for every library of ``names`` neither built nor
    being built, without waiting; ``nice`` lowers their CPU priority (so
    that they compile on the cores the caller's own work leaves idle).
    Returns the names started.  :func:`build` waits for them."""
    out_dir = lib_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    with _running_lock:
        for n in names:
            if n in _running or (out_dir / f"lib{n}.so").exists():
                continue
            tmp = out_dir / f"lib{n}.{os.getpid()}.tmp.so"
            src, defines = DEFINES.get(n, (n, ()))
            cmd = [nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o",
                   str(tmp), str(CSRC / f"{src}.cu")]
            with open(out_dir / f"{n}.log", "w") as log:
                proc = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True,    # cancel() stops the group
                    preexec_fn=(lambda: os.nice(nice)) if nice else None)
            _running[n] = (tmp, proc)
            _started[n] = time.time()
            started.append(n)
    return started


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not yet built -- those not yet
    started all in parallel -- and wait for them.

    Returns {name: path of the .so}.  ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) is kept beside each
    library as ``<name>.log``."""
    out_dir = lib_dir()
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    start(names)
    failed = []
    with _running_lock:
        for n in names:
            if n not in _running:
                continue
            tmp, proc = _running.pop(n)
            proc.wait()
            if proc.returncode != 0:
                log = (out_dir / f"{n}.log").read_text()
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) "
                              f"---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                seconds[n] = tmp.stat().st_mtime - _started[n]
                os.replace(tmp, paths[n])   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def building() -> list[str]:
    """The libraries whose ``nvcc`` is still running."""
    with _running_lock:
        return [n for n, (_, proc) in _running.items()
                if proc.poll() is None]


def cancel() -> list[str]:
    """Stop every ``nvcc`` started and not waited for (with the compiler
    processes it started), writing no library; returns their names."""
    with _running_lock:
        names = list(_running)
        for n in names:
            tmp, proc = _running.pop(n)
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            proc.wait()
            tmp.unlink(missing_ok=True)
    return names


def layout_library(spec) -> str:
    """The tensor-core K2 library of ``spec``'s lane layout:
    ``ulppack_matmul_mma`` for int16xP2s8, a ``LAYOUT_VARIANTS`` library
    for every other layout of the family."""
    if (spec.lane_name, spec.n_pack, spec.shift) == ("int16", 2, 8):
        return "ulppack_matmul_mma"
    name = f"ulppack_matmul_mma_{spec.lane_name}xP{spec.n_pack}s{spec.shift}"
    if name not in LAYOUT_VARIANTS:
        raise ValueError(f"no tensor-core K2 library for {spec}")
    return name


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use, or waited for
    when it is being built)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build((name,))[name]))
    return lib


def bind(name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """Bind ``int fn(void* x n_ptrs, int x n_ints, int device, void*
    stream)`` from library ``name``; the returned callable raises
    RuntimeError when the entry point reports a CUDA error."""
    lib = load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err_str = lib.repro_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def call(*args):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{fn_name}: CUDA error {err} "
                f"({err_str(err).decode(errors='replace')})")

    return call
