"""Build of the port's C++ host library (`csrc/host/*.cpp`) at first use.

The library is a build artifact (not committed): `ensure_built()` runs g++
into `csrc/build/`, naming the library by a hash of its sources and flags
so that an edited source rebuilds, under a file lock so that concurrent
processes build it once.  A failed build raises with the compiler's
output; no caller falls back to another path because of it.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

HOST_DIR = Path(__file__).resolve().parent.parent / 'csrc' / 'host'
BUILD_DIR = HOST_DIR.parent / 'build'
CXX_FLAGS = ['-O3', '-std=c++17', '-fPIC', '-Wall', '-march=native']


def _sources():
    return sorted(HOST_DIR.glob('*.cpp'))


def _compiler() -> str:
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if not cxx:
        raise RuntimeError('no C++ compiler: set CXX or put g++ on PATH')
    return cxx


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'libmv2d_host_{h.hexdigest()[:16]}.so'


def ensure_built() -> Path:
    """Returns the library's path, compiling it when it is missing."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / 'host.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix('.tmp')
        r = subprocess.run(
            [_compiler(), *CXX_FLAGS, '-shared', *map(str, _sources()),
             '-o', str(tmp), '-lpthread'],
            capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f'building {lib.name} failed:\n{r.stdout}'
                               f'{r.stderr}')
        os.replace(tmp, lib)
    return lib
