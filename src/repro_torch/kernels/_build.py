"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on
first use into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the
repository root, for ``sm_90a`` (Hopper). The hash covers the source
and the flags, so an edited source is rebuilt and a stale library is
never loaded. A failed build raises with nvcc's stderr; nothing falls
back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("param_stats", "kmeans_assign", "flash_decode", "flash_attention")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# --split-compile=0 runs the optimizer over one source on every CPU (the
# 100 template instances of flash_decode.cu take half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the storage types every kernel reads, by the code each csrc launcher
# takes: what the configs can produce (models/layers.DTYPES and
# attention.cache_dtype); each kernel converts them to fp32 on load
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                 torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}

_loaded: dict = {}


def storage_code(dtype: torch.dtype, what: str) -> int:
    """The launcher's code of a storage type; any other type (fp64, an
    integer type) raises TypeError naming ``what``."""
    if dtype not in STORAGE_CODES:
        raise TypeError(f"{what} must be of {', '.join(str(t)[6:] for t in STORAGE_CODES)}, "
                        f"got {dtype}")
    return STORAGE_CODES[dtype]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns
    ``{name: compiler output}`` (ptxas' register and shared-memory
    report) for the sources it compiled; the output is also kept beside
    each library (:func:`build_log`)."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        logs[n] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{err}")
        else:
            library_path(n).with_suffix(".log").write_text(logs[n])
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``csrc/<name>.cu``'s
    current library ("" if it was built without one)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
