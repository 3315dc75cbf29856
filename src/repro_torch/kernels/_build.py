"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared
library with a plain ``extern "C"`` interface and loaded with ``ctypes``.
The build runs at first use into ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``); the library's file name carries
a hash of the sources and flags, so an edited source is never served a
stale build.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ddim_step.cu", "dpmpp_step.cu", "flash_attention.cu",
           "flash_attention_sm90.cu", "group_mean.cu", "launch_floor.cu",
           "ssd_scan.cu")
#: headers the sources include (part of the build's hash)
HEADERS = ("tf32x3.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# (name, argtypes) of every launcher; each returns its cudaGetLastError()
SIGNATURES = {
    # z, eps_u, eps_c, out, alphas, sigmas, n_table, t, t_next, t_stride,
    # t_next_stride, guidance, clip_x0, n, n_per_row, then the launch plan:
    # threads, vec; dtype, stream
    "sage_ddim_step": (_P, _P, _P, _P, _P, _P, _LL, _P, _P, _LL, _LL, _F,
                       _F, _LL, _LL, _I, _I, _I, _P),
    # z, eps_u, eps_c, eps_prev, out, eps_out, a_t, s_t, a_n, s_n, lam,
    # lam_p, lam_n, first (bool), guidance, clip_x0, n, n_per_row,
    # row_stride, first_stride, then the launch plan: threads, vec; dtype,
    # stream
    "sage_dpmpp_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _F, _F, _LL, _LL, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, B, Sq, Sk, H, Hkv, D, scale, causal, window, dtype,
    # stream; f32 only (dtype 0; bf16 takes the sm90 launcher)
    "sage_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _I, _I, _P),
    # the same arguments with the padded head-dim width after D, bf16 only
    "sage_flash_attention_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _I, _I, _I, _P),
    # padded width -> the sm90 kernel's dynamic shared memory in bytes (not a
    # launcher)
    "sage_flash_attention_sm90_smem": (_I,),
    # x, mask, out, K, N, F, then the launch plan: threads, vec; dtype,
    # stream
    "sage_group_mean": (_P, _P, _P, _I, _I, _LL, _I, _I, _I, _P),
    # blocks_x, blocks_y, threads, stream: an empty kernel (the launch's
    # own cost, a yardstick for chip_smoke.py)
    "sage_launch_floor": (_I, _I, _I, _P),
    # x, dA, B, C, y, states, batch, chunks, heads, Q, P, N, dtype, stream
    "sage_ssd_intra_chunk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P),
}

#: seconds the last build took (0.0 when a cached library was loaded)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsage_kernels-{_digest()}.so"


def build() -> Path:
    """Compile the sources (unless this exact build exists) and return the
    library's path.  Raises with nvcc's output when a compile fails."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, failed = [], []
        for name, obj, p in procs:
            log, _ = p.communicate()
            (Path(tmp) / (name + ".log")).write_text(log)
            if p.returncode:
                failed.append(f"--- {name} (rc {p.returncode})\n{log}")
            objs.append(str(obj))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            shutil.copy(Path(tmp) / (name + ".log"),
                        BUILD_DIR / (name + ".ptxas.log"))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", *objs, "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def forbid_grad(what: str, *tensors) -> None:
    """Raise when autograd would record through a kernel wrapper: grad mode
    is on and an input requires grad.  The kernels have no backward (as in
    the JAX package, whose Pallas kernels have no VJP), so their outputs
    carry no ``grad_fn`` and would cut the gradient without a word.
    Training takes the plain routes (``attn_impl="naive"``, the reference
    group mean); the serving path calls the kernels without autograd."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input requires grad under grad "
            f"mode.  Call it under torch.no_grad(), or differentiate "
            f"through its plain route")


def check(rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
