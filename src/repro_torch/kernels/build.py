"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The libraries go to ``build/repro_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  All sources build in parallel, one
``nvcc`` each, at first use.  A missing ``nvcc`` or a failed build raises with
nvcc's stderr; there is no fallback.

:func:`call` passes tensors as their data pointers (``ctypes.c_void_p``
arguments) and appends the current stream
(``current_stream``: the raw handle of PyTorch's current stream on the
tensor's device); every C entry point returns
``cudaGetLastError()`` and :func:`check` raises on non-zero.  The
kernels' shared host state lives here too: the card's SM count, which the
planners take (:func:`sm_count`), and the ticket counters of the kernels
whose last CTA merges (:func:`tickets`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("softmax_topk", "flash_decode_paged", "flash_attention_paged",
           "flash_decode", "flash_attention_offset", "flash_attention_fwd",
           "flash_attention_bwd", "online_softmax", "flash_mla")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}
#: nvcc's output (ptxas register / shared-memory / spill report) per source,
#: from the builds this process ran.
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels of repro_torch need the CUDA toolkit to build")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names=SOURCES) -> list[str]:
    """Compile every source whose library is missing, all in parallel.
    Returns the names that were built (empty when all were cached)."""
    missing = [n for n in names if not lib_path(n).exists()]
    if not missing:
        return []
    nvcc = nvcc_path()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode})\n{stderr}")
            continue
        os.replace(tmp, lib_path(name))
    if failures:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n"
                           + "\n".join(failures))
    return missing


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def call(name: str, argtypes: list, args, *,
         source: str | None = None) -> None:
    """Call ``<name>_launch`` of ``csrc/<source>.cu`` (``source`` defaults
    to ``name``) on ``args``: tensors pass as their data pointers, and the
    current stream of the first tensor's device is appended.  Raises if the
    launch reported a CUDA error.  The entry point is looked up once and
    the arguments pass as plain ints and floats, so a call costs the host
    a few microseconds (a small kernel's launch is host-bound otherwise)."""
    import torch
    key = (source or name, name)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(library(key[0]), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    dev = args[0].device
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    if dev.index == torch.cuda.current_device():
        err = fn(*c_args, current_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*c_args, current_stream(dev.index))
    if err:
        check(library(key[0]), err, f"{name} kernel")


def current_stream(index: int | None) -> int:
    """The raw handle of PyTorch's current CUDA stream on device ``index``
    (None: the current device): what ``torch.cuda.current_stream(index)
    .cuda_stream`` gives, without building a ``Stream`` object, which costs
    the host more than the rest of a launch (``tools/decode_times.py``
    times both)."""
    import torch
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_SM_COUNT: dict[int, int] = {}
_TICKETS: dict[tuple[int, int], "torch.Tensor"] = {}


def sm_count(device) -> int:
    """The card's streaming multiprocessors (read once per device)."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def tickets(device, n: int):
    """At least ``n`` ticket counters for the kernels' last-CTA merge (the
    split decode's and the fused softmax+top-k's): int32 zeros, which every
    call leaves zero (the merging CTA sets its counter back), kept per
    device and stream so that calls on two streams never share one."""
    import torch
    key = (device.index, current_stream(device.index))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                        device=device)
    return t


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 tensors, "
                         f"not {t.dtype}")
    return DTYPE_CODES[name]
