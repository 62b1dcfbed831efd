"""Builds the CUDA sources in ``csrc/`` into one shared library and loads it.

The library has a plain C interface and is loaded with ``ctypes``; nothing here
includes PyTorch's headers, so a build takes seconds.  It happens at first use
(never at import), from the sources alone, into ``_build/`` next to this file,
under a name keyed by a hash of the sources and flags so that an edit rebuilds.
Each ``.cu`` file is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one ``.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the C interface's codes for the element types the kernels take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib: ctypes.CDLL | None = None
#: what the last build in this process did: seconds, library path, nvcc's output
#: (``-Xptxas -v``: registers, shared memory and spills of every kernel).
build_info: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "repro_torch.kernels: no nvcc found (looked at PATH and "
        "$CUDA_HOME/bin); the kernels cannot be built, and a CUDA tensor is "
        "never handed to the plain version instead")


def _build(target: Path) -> None:
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log: list[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for cmd, obj, proc in jobs:
            out, _ = proc.communicate()
            log.append("$ " + " ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                for _, _, other in jobs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {cmd[-3]}:\n{out}")
            objs.append(str(obj))
        out_tmp = Path(tmp) / target.name
        cmd = [nvcc, "-shared", "-o", str(out_tmp), *objs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(cmd) + "\n" + link.stdout)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out_tmp, target)  # atomic: a concurrent build of the same sources loses nothing
    build_info.update(built=True, seconds=time.perf_counter() - t0,
                      log="\n".join(log))


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class RmsnormCall(ctypes.Structure):
    """``struct RmsnormCall`` of ``csrc/rmsnorm.cu``: one launch's arguments."""
    _fields_ = [("x", _P), ("w", _P), ("y", _P), ("stream", _P), ("rows", _I),
                ("d", _I), ("eps", _F), ("x_dtype", _I), ("w_dtype", _I),
                ("device", _I)]


class RmsnormBwdCall(ctypes.Structure):
    """``struct RmsnormBwdCall`` of ``csrc/rmsnorm_bwd.cu``."""
    _fields_ = [("x", _P), ("w", _P), ("dy", _P), ("dx", _P), ("dw", _P),
                ("partial", _P), ("stream", _P), ("rows", _I), ("d", _I),
                ("eps", _F), ("workers", _I), ("x_dtype", _I), ("w_dtype", _I),
                ("device", _I)]


FLASH_BWD_TENSORS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


class FlashBwdCall(ctypes.Structure):
    """``struct FlashBwdCall`` of ``csrc/flash_attention_bwd.cu``."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "o", "dout", "lse", "delta",
                                   "dq_acc", "dq", "dk", "dv", "stream")]
                + [(n, _I) for n in ("B", "Sq", "Skv", "H", "KV", "hd")]
                + [(f"{t}_{s}", _LL) for t in FLASH_BWD_TENSORS
                   for s in ("sb", "ss", "sh")]
                + [("causal", _I), ("window", _I), ("softcap", _F), ("dtype", _I),
                   ("device", _I)])


#: the library's C interface, name -> (restype, argtypes); ``load()`` binds it and
#: a CPU test holds it against the ``extern "C"`` declarations in ``csrc/``
#: (a pointer to a struct is a ``c_void_p`` here: the address of a ``RmsnormCall``)
SIGNATURES = {
    "repro_rmsnorm_fwd": (_I, [_P]),
    "repro_rmsnorm_bwd": (_I, [_P]),
    "repro_flash_attention_fwd": (
        _I, [_P] * 5 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _I, _I, _P]),
    "repro_flash_attention_variant": (_I, [_I, _I]),
    "repro_flash_attention_bwd": (_I, [_P]),
    "repro_flash_attention_bwd_variant": (_I, [_I, _I]),
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
}

#: what the launchers' negative return codes mean
REFUSALS = {
    -1: "head_dim not compiled in",
    -2: "unsupported element type",
    -3: "a TMA tensor map could not be encoded for these tensors",
    -4: "the driver's cuTensorMapEncodeTiled is unavailable",
    -5: "a row too wide for the kernel's shared memory, or a bad worker count",
}


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this source tree has not built it."""
    global _lib
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    build_info.update(built=False, seconds=0.0, log="", library=str(target))
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned anything but 0."""
    if code == 0:
        return
    if code > 0:
        msg = load().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
    raise RuntimeError(f"{what}: launcher refused the call (code {code}: "
                       f"{REFUSALS.get(code, 'unknown')})")
