"""Build and bind the hand-written CUDA kernels under `csrc/`.

Every `csrc/*.cu` is compiled with nvcc for sm_90a into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  The library lands in `csrc/build/`, named by a hash
of the sources, so an edited source rebuilds; a file lock serialises
concurrent builds.  Nothing here runs at import time: the first kernel
launch builds and loads the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = CSRC / 'build'
ARCH_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a']
CUTLASS_INCLUDE = Path('/usr/local/cutlass/include')

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (every function returns the
# cudaError_t of its launch as an int)
SIGNATURES = {
    'mv2d_bottleneck': [_P] * 10 + [_I] * 5 + [_P],
    'mv2d_dcn_conv': [_P] * 6 + [_I] * 8 + [_P],
    'mv2d_dcn_samples': [_P] * 5 + [_I] * 7 + [_P],
    'mv2d_dcn_samples_bwd': [_P] * 10 + [_I] * 7 + [_P],
    'mv2d_roi_align': [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 2
                      + [_I] * 4 + [_P],
    'mv2d_roi_align_bwd': [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 4
                          + [_I] * 4 + [_P],
    'mv2d_mask_bits': [_P] * 2 + [_I] * 2 + [_P],
    'mv2d_masked_attention': [_P] * 11 + [_I] * 6 + [_P],
    'mv2d_masked_attention_bwd': [_P] * 16 + [_I] * 6 + [_P],
    'mv2d_identity_block': [_P] * 8 + [_I] * 5 + [_P],
    'mv2d_dcn_conv_bwd': [_P] * 12 + [_I] * 8 + [_P],
    'mv2d_roi_align_flat': [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 3
                           + [_I] * 5 + [_P],
    'mv2d_roi_align_slab': [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 3
                           + [_I] * 5 + [_P],
}
# host functions returning a size (64-bit): a launch's workspace in bytes,
# or a kernel's tiling; name -> argument types
SIZES = {
    'mv2d_dcn_samples_bwd_workspace': [_I] * 7,
    'mv2d_dcn_conv_bwd_workspace': [_I] * 8,
    'mv2d_identity_block_tile_rows': [_I],
    'mv2d_identity_block_smem': [_I],
    'mv2d_roi_align_stream_plan': [_I] * 2,
}


def _sources():
    return sorted(CSRC.glob('*.cu')), sorted(CSRC.glob('*.cuh'))


def source_digest() -> str:
    h = hashlib.sha256()
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(' '.join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [os.path.join(os.environ[k], 'bin', 'nvcc')
             for k in ('CUDA_HOME', 'CUDA_PATH') if os.environ.get(k)]
    cands += ['/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or '']
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/libmv2d_kernels_<hash>.so (no-op when
    that library exists).  verbose prints nvcc's register/smem report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f'libmv2d_kernels_{source_digest()}.so'
    with open(BUILD_DIR / 'lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        nvcc = _nvcc()
        flags = ['-O3', '-std=c++17', '-Xcompiler', '-fPIC', *ARCH_FLAGS,
                 f'-I{CSRC}']
        if CUTLASS_INCLUDE.is_dir():
            flags.append(f'-I{CUTLASS_INCLUDE}')
        if verbose:
            flags += ['-Xptxas', '-v']
        cus, _ = _sources()
        objs, procs = [], []
        for src in cus:
            obj = BUILD_DIR / f'{src.stem}_{source_digest()}.o'
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src.name}:\n{out}')
            if verbose and out:
                print(out)
        tmp = lib_path.with_suffix('.tmp')
        subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp),
                        *map(str, objs)], check=True)
        os.replace(tmp, lib_path)
        for obj in objs:
            obj.unlink()
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in SIZES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        _lib = handle
    return _lib


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f'kernel takes float32 or bfloat16, got {t.dtype}')
    return DTYPE_CODES[t.dtype]


def check_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor handed to a kernel is a contiguous tensor on the
    current CUDA device, 16-byte aligned (the kernels load 16 bytes at a
    time)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f'kernel input on {t.device}, expected CUDA')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('kernel input must be contiguous and 16-byte '
                             'aligned')
    dev = torch.cuda.current_device()
    if any(t.device.index != dev for t in tensors):
        raise ValueError(f'kernel inputs must lie on cuda:{dev}')


def workspace_bytes(name: str, *args) -> int:
    """The bytes of scratch a launch needs, from the C function `name`."""
    return int(getattr(lib(), name)(*args))


def launch(name: str, *args, handle: ctypes.CDLL | None = None) -> None:
    """Call a C entry point of `handle` (default: the port's library) on the
    current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(handle or lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')
