"""Build the port's CUDA kernels and load them through ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  Forward libraries export `tdc_<name>_fwd`, backward libraries
`tdc_<name>_bwd`, each with its own signature.  Libraries go to
`tdc_video_tpu_torch/_build/`, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.  `build_all` starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
host may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("flash_kernel", "full_attention_nhd", "full_attention_nhd_seqq", "full_attention",
           "flash_dq_kernel", "flash_dkv_kernel")
BACKWARD = ("flash_dq_kernel", "flash_dkv_kernel")
# the libraries whose bf16 kernels run on wgmma (sm_90a), each with the name
# of those kernels: the four forward kernels K1-K4 at head dims above 32
# (csrc/flash_fwd_sm90.cuh), K5 and K6
SM90 = {"flash_kernel": "flash_fwd_bf16_sm90_kernel",
        "full_attention_nhd": "flash_fwd_bf16_sm90_kernel",
        "full_attention_nhd_seqq": "flash_fwd_bf16_sm90_kernel",
        "full_attention": "flash_fwd_bf16_sm90_kernel",
        "flash_dq_kernel": "flash_dq_bf16_kernel", "flash_dkv_kernel": "flash_dkv_bf16_kernel"}

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse (or None), is_f32, B, T, S, Hq, Hkv, D, kv_len, 12 strides
# (q, k, v, o), causal, scale, stream; K1 takes its causal query offset
# after causal
FWD_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                ctypes.POINTER(ctypes.c_int64), _I, ctypes.c_float, _P]
K1_ARGTYPES = FWD_ARGTYPES[:15] + [_I] + FWD_ARGTYPES[15:]
# q, k, v, dO, lse, delta, dQ, dK, dV (unused ones None), is_f32, B, T, S, Hq,
# Hkv, D, kv_len, 21 strides (q, k, v, dO, dQ, dK, dV), causal, q_offset,
# scale, stream
BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                ctypes.POINTER(ctypes.c_int64), _I, _I, ctypes.c_float, _P]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Tuple[Dict[str, Path], float, str]:
    """Compile every missing library, one nvcc process per source, all
    started together; each library's compiler output is kept beside it (.log).
    Returns ({name: path}, seconds, the compiler output of every library in
    `names`, this build's or the one that made it: ptxas's registers, spills
    and warnings per kernel)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    logs = {n: paths[n].with_suffix(".log") for n in names}
    todo = [n for n in names if not (paths[n].exists() and logs[n].exists())]
    procs: List[Tuple[str, subprocess.Popen, Path]] = []
    if todo:
        nvcc = nvcc_path()
        for n in todo:
            tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), tmp))
    failed = []
    for n, proc, tmp in procs:
        out, _ = proc.communicate()
        out = f"--- nvcc {n}.cu (rc {proc.returncode})\n{out}"
        if proc.returncode != 0:
            failed.append(out)
        else:
            logs[n].write_text(out)
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths, time.perf_counter() - t0, "\n".join(logs[n].read_text() for n in names)


def entry_point(name: str) -> str:
    return f"tdc_{name}_{'bwd' if name in BACKWARD else 'fwd'}"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _libs:
        paths, _, _ = build_all((name,))
        lib = ctypes.CDLL(str(paths[name]))
        fn = getattr(lib, entry_point(name))
        fn.argtypes = (BWD_ARGTYPES if name in BACKWARD
                       else K1_ARGTYPES if name == "flash_kernel" else FWD_ARGTYPES)
        fn.restype = ctypes.c_int
        lib.tdc_error_string.argtypes = [ctypes.c_int]
        lib.tdc_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]
