"""Build the port's CUDA kernels at first use and bind them through ctypes.

Every ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launch
functions that take raw pointers, sizes and a stream, and return
``cudaGetLastError()``).  ``nvcc`` compiles each source on its own into a
shared library under ``build/kernels/`` at the repository root (git
-ignored); the file name carries a hash of the source, the headers it may
include (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is reused.  Building takes seconds per source;
``build_all`` starts one ``nvcc`` per source at once.

No flag makes arithmetic approximate: ``--use_fast_math`` would turn the
quantize kernel's IEEE division into an approximate one and break its
bit-equality with the plain version.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

# library -> {C function: (argtypes, restype)}
SIGNATURES = {
    "flash_attention": {
        "flash_attention_launch": ([_P] * 5 + [_I] * 5 + [_L] * 9
                                   + [_I, _I, _F, _I, _P], _I),
        "flash_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": ([_P] * 12 + [_I] * 5 + [_L] * 15
                                       + [_F, _I, _I, _P], _I),
        "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "quantize": {
        "quantize_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "quantize_rows_launch": ([_P, _P, _P] + [_I] * 6 + [_P], _I),
        "dequantize_launch": ([_P, _P, _P] + [_I] * 6 + [_P], _I),
        "quantize_error_string": ([_I], ctypes.c_char_p),
    },
    "ssd": {
        "ssd_scan_launch": ([_P] * 7 + [_I] * 6 + [_L] * 10 + [_I, _P], _I),
        "ssd_error_string": ([_I], ctypes.c_char_p),
    },
    "ssd_bwd": {
        "ssd_scan_bwd_launch": ([_P] * 15 + [_I] * 7 + [_L] * 10 + [_I, _P],
                                _I),
        "ssd_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "silu": {
        "silu_launch": ([_P, _L, _P, _I, _I, _I, _P], _I),
        "conv_silu_launch": ([_P, _P, _L, _L, _P, _P, _P] + [_I] * 5 + [_P],
                             _I),
        "conv_silu_bwd_launch": ([_P, _L, _L] + [_P] * 7 + [_I] * 8 + [_P],
                                 _I),
        "silu_error_string": ([_I], ctypes.c_char_p),
    },
    "norm": {
        "rms_norm_rows_launch": ([_I, _P, _L, _P, _L, _P, _L, _P, _I, _P, _P,
                                  _P] + [_I] * 5 + [_F, _I, _P], _I),
        "gated_rms_norm_bwd_launch": ([_P, _L, _P, _L, _P, _L, _P, _I]
                                      + [_P] * 8 + [_I] * 5 + [_F, _I, _P],
                                      _I),
        "norm_error_string": ([_I], ctypes.c_char_p),
    },
    "decode": {
        "rows_matmul_launch": ([_P, _L, _P, _L, _L, _P, _L, _P, _P]
                               + [_I] * 7 + [_P], _I),
        "decode_attention_launch": ([_P, _L, _L, _P, _P] + [_L] * 6
                                    + [_P, _P] + [_I] * 6 + [_F, _I, _I, _P],
                                    _I),
        "ssm_decode_launch": ([_P, _P, _L, _L, _P, _L, _P, _P, _L, _P, _L, _P]
                              + [_I] * 5 + [_P], _I),
        "decode_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch resolves it, else
    ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH)")
    return found


def library_path(name: str) -> Path:
    """The library's file: the hash covers the source, the shared headers
    of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def resource_usage(name: str) -> dict[str, tuple[int, int]]:
    """{kernel: (registers, stack bytes)} of the built library ``name``,
    from ``cuobjdump -res-usage``; a stack frame is where spills go."""
    exe = Path(nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-res-usage", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    found = re.findall(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+)", out)
    return {f: (int(r), int(s)) for f, r, s in found}


def build_all(names=tuple(SIGNATURES)) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns wall seconds per source
    built (0.0 for one already built).  Raises with the compiler's output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        exe = exe or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def check(name: str, fn: str, err: int) -> None:
    """Raise when a launch function returned a CUDA error."""
    if err:
        lib = load(name)
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")
