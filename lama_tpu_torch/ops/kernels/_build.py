"""Build and load the port's CUDA kernels.

Each source under `lama_tpu_torch/csrc/` is compiled on first use by one
`nvcc -shared` call for Hopper (`-gencode arch=compute_90a,code=sm_90a`) into
a shared library with a plain C interface, which is loaded with `ctypes`.
No PyTorch headers are included, so a source builds in seconds, and nothing
needs `ninja`. Libraries land in `lama_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. A failed build raises.
Importing this module builds nothing.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')
SOURCES = ('reflect_conv', 'fourier_unit', 'halo_conv', 'conv3x3_wgmma',
           'conv3x3_simt', 'stem_conv', 'conv_int8')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-shared', '-Xcompiler',
                           '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda's,
    or the one on PATH."""
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels of '
                       'lama_tpu_torch are built from source at first use')


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + '.cu')


def library_path(name: str) -> str:
    with open(source_path(name), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one `nvcc` per
    source, all started together. Returns the seconds each took (0.0 when
    the library was already built). The ptxas report (registers, shared
    memory, spills) is kept beside each library as `<library>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [nvcc(), *NVCC_FLAGS, '-o', tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'{source_path(name)}:\n{log}')
            continue
        with open(out + '.log', 'w') as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
