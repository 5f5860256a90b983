"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, into ``build/kernels/lib<name>-<digest>.so`` at the repo root
(listed in ``.gitignore``); the digest covers every file in ``csrc`` and
the flags, so an edited source never loads a stale library.  The libraries
expose plain C functions and are loaded with ``ctypes``.  Nothing here runs
at import time: the first launch of a kernel builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each library's one exported launcher: (name, argtypes)
SIGNATURES = {
    "quantize": ("repro_quantize_rowwise", (_P, _I, _P, _P, _I, _I, _P)),
    "swiglu_quant": ("repro_swiglu_quant", (_P, _P, _P, _I, _I, _P)),
    "permute_pad": ("repro_permute_pad",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "grouped_gemm_fp8": ("repro_grouped_gemm_fp8",
                         (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P)),
    "fp8_transpose": ("repro_fp8_transpose", (_P, _P, _P, _P, _I, _I, _I, _P)),
    "grouped_gemm_nt_fp8": ("repro_grouped_gemm_nt_fp8",
                            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P)),
    "grouped_gemm_swiglu_quant": ("repro_grouped_gemm_swiglu_quant",
                                  (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _P)),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}
build_report: Dict[str, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile into BUILD_DIR every source that has no library for the
    current digest; returns {name: library path}.  Raises with nvcc's output
    on failure, after every nvcc process has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    t0 = time.perf_counter()
    outs, procs = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}-{tag}.so"
        outs[src.stem] = out
        if out.exists():
            continue
        tmp = BUILD_DIR / f".lib{src.stem}-{tag}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---"
                          f"\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    build_report.update(seconds=time.perf_counter() - t0,
                        compiled=sorted(procs), logs=logs)
    return outs


def kernel(name: str):
    """The C launcher of library `name`, building and loading on first use."""
    fn = _loaded.get(name)
    if fn is None:
        paths = build()
        for lib_name, (sym, argtypes) in SIGNATURES.items():
            f = getattr(ctypes.CDLL(str(paths[lib_name])), sym)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _loaded[lib_name] = f
        fn = _loaded[name]
    return fn


def launch(name: str, *args) -> None:
    """Call launcher `name` on the current CUDA stream; raise on a launch
    error (the launcher returns cudaGetLastError())."""
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel(name)(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
