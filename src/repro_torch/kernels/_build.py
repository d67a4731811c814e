"""Build the CUDA sources in `csrc/` at first use and load them with ctypes.

Each `.cu` file is compiled by nvcc on its own, all of them at once, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

No PyTorch header is included, so a build takes seconds. The libraries go
into `_build/<hash>/` beside this file, keyed by a hash of every source
and the flags, so an edited source rebuilds and an unchanged one is reused.
ptxas's register and shared-memory report is kept in `<name>.log` there.

Each launcher returns `cudaGetLastError()` after its launch; `check()`
raises on a nonzero code. A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
_F = ctypes.c_float
# C signature of each launcher: (symbol, argtypes). Pointers and the stream
# are c_void_p, so ctypes passes them as 64-bit values.
LAUNCHERS = {
    "dense_field": ("dense_field_launch", [_P, _P, _P, _P, _P, _I, _I, _P]),
    "tau_leap": ("tau_leap_launch", [_P] * 9 + [_I] * 3 + [_P]),
    "tau_leap_faults": ("tau_leap_faults_launch", [_P] * 9 + [_I] * 3 + [_P]),
    "lattice_gibbs": ("lattice_gibbs_launch", [_P] * 9 + [_I] * 7 + [_P]),
    "lattice_gibbs_faults": ("lattice_gibbs_faults_launch", [_P] * 11 + [_I] * 6 + [_P]),
    "lattice_gibbs_generic": ("lattice_gibbs_generic_launch", [_P] * 9 + [_I] * 5 + [_P]),
    "lattice_gibbs_generic_faults": ("lattice_gibbs_generic_faults_launch",
                                     [_P] * 11 + [_I] * 4 + [_P]),
    "lattice_energy": ("lattice_energy_launch", [_P] * 4 + [_I] * 4 + [_P]),
    "sparse_fields": ("sparse_fields_launch", [_P] * 5 + [_I] * 5 + [_P]),
    "sparse_energy": ("sparse_energy_launch", [_P] * 6 + [_I] * 6 + [_P]),
    "sparse_energy_samples": ("sparse_energy_samples_launch", [_P] * 5 + [_I] * 6 + [_P]),
    "colored_gibbs": ("colored_gibbs_launch", [_P] * 7 + [_I] * 6 + [_P]),
    "colored_gibbs_faults": ("colored_gibbs_faults_launch", [_P] * 9 + [_I] * 6 + [_P]),
    "colored_gibbs_samples": ("colored_gibbs_samples_launch", [_P] * 7 + [_I] * 8 + [_P]),
    "colored_gibbs_long": ("colored_gibbs_long_launch", [_P] * 7 + [_IP] + [_I] * 5 + [_P]),
    "flash_attention": ("flash_attention_launch", [_P] * 4 + [_I] * 8 + [_P]),
    "ctmc_event": ("ctmc_event_launch", [_P] * 12 + [_I] * 3 + [_F, _P]),
}
# The library of a launcher that does not live in csrc/<its name>.cu
LIBRARY = {"lattice_gibbs_generic": "lattice_gibbs", "tau_leap_faults": "tau_leap",
           "lattice_gibbs_faults": "lattice_gibbs",
           "lattice_gibbs_generic_faults": "lattice_gibbs",
           "colored_gibbs_faults": "colored_gibbs", "colored_gibbs_samples": "colored_gibbs",
           "sparse_energy_samples": "sparse_energy"}
LIBRARIES = tuple(dict.fromkeys(LIBRARY.get(n, n) for n in LAUNCHERS))

_lock = threading.Lock()
_loaded: dict = {}  # name -> ctypes launcher, loaded once per process
_libs: dict = {}  # library -> ctypes.CDLL, loaded once per process


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or the toolkit's default prefix (the
    search torch.utils.cpp_extension makes)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_dir() -> Path:
    """Directory of the libraries built from the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=LIBRARIES) -> Path:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together. Returns the build directory."""
    out_dir = _build_dir()
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir


def launcher(name: str):
    """The ctypes launcher `name`, building its library on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            library = LIBRARY.get(name, name)
            lib = _libs.get(library)
            if lib is None:
                lib = _libs[library] = ctypes.CDLL(str(build_all((library,)) / f"lib{library}.so"))
            symbol, argtypes = LAUNCHERS[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def check(name: str, code: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
