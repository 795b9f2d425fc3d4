"""nvcc build of the hand-written CUDA kernels (ngmlr_tpu_torch/csrc).

Each ``csrc/*.cu`` compiles to an object in its own nvcc process, all
started together (headers, ``*.cuh`` and ``*.h``, count in the key), and the objects link into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use and is
keyed on a hash of the sources and flags, so a fresh checkout builds
everything from the repository's own files and a second process reuses the
library. Nothing is downloaded.

Flags: ``-fmad=false`` and no fast math — the kernels must round every f32
operation exactly as the JAX reference does (see csrc/common.cuh).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_NAME = "libngmlr_torch_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh", ".h")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises with nvcc's output on any failure."""
    global build_seconds
    out_dir = os.path.join(BUILD_DIR, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs = []
        for cmd, p in procs:
            out, _ = p.communicate()
            logs.append(out.decode(errors="replace"))
            if p.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError("nvcc failed: %s\n%s"
                                   % (" ".join(cmd), logs[-1]))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed: %s\n%s"
                               % (" ".join(cmd), r.stdout + r.stderr))
        if verbose:
            print("".join(logs), end="")
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds race safely
    build_seconds = time.perf_counter() - t0
    return lib_path


def _bind(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "ngt_score_fill": [p, i64, p, i64, p, i32, i32, i32, p, p],
        "ngt_corridor_windows": [p, i32, i32, p, p, p, p],
        "ngt_convex_fill": [p, i64, p, i64, p, p, p, p, i32, i32, i32,
                            p, p, p, p, p, p],
        "ngt_convex_backtrack": [p, p, p, p, p, i32, i32, i32, p, p, p, p, p],
        "ngt_expand_votes": [p, p, p, i32, i32, i32, p, p, p, p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ngt_convex_fill_state_bytes.argtypes = [i32]
    lib.ngt_convex_fill_state_bytes.restype = i64
    lib.ngt_convex_fill_smem_cap.argtypes = []
    lib.ngt_convex_fill_smem_cap.restype = i64
    # the native wave (csrc/wave.cu, pipeline/native_engine.NativeWave)
    lib.ngt_wave_create.argtypes = []
    lib.ngt_wave_create.restype = p
    lib.ngt_wave_destroy.argtypes = [p]
    lib.ngt_wave_destroy.restype = None
    lib.ngt_wave_launch.argtypes = [p, p, i64, p, i64, p]
    lib.ngt_wave_launch.restype = ctypes.c_int
    lib.ngt_wave_fetch.argtypes = [p, p, p]
    lib.ngt_wave_fetch.restype = ctypes.c_int
    lib.ngt_wave_plan.argtypes = [p, p, p, p, p]
    lib.ngt_wave_plan.restype = None
    return lib


def get_lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib
