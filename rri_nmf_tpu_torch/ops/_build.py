"""Build and load the CUDA kernels of ``rri_nmf_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only: ``-gencode arch=compute_90a,code=sm_90a``. The library goes
to ``build/rri_nmf_tpu_torch/`` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing file. The build runs at the first kernel launch,
never at import.

The C functions take raw device pointers and the CUDA stream as
``c_void_p`` and the device index as an int, and return
``cudaGetLastError()`` after their launch; the wrappers in
:mod:`rri_nmf_tpu_torch.ops.dense_kernels` raise when it is not 0.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'rri_nmf_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# (name, argtypes): pointers and the stream as c_void_p — a bare Python
# int would be passed as a 32-bit int and cut the pointer
SIGNATURES = {
    'rri_gs_f32': [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P],
    'rri_gs_f64': [_P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _I, _I, _P],
    'rri_tm_proj_f32': [_P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P],
    'rri_tm_proj_f64': [_P, _P, _P, _P, _I, _I, _D, _D, _D, _I, _I, _P],
}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    on_path = shutil.which('nvcc')
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and '
                       '/usr/local/cuda/bin); the CUDA kernels cannot be '
                       'built')


def sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ('librri_nmf_kernels_%s.so' % h.hexdigest()[:16])


def build(verbose=False):
    """Compile the library if it is not built yet; returns its path.

    Writes to a temporary file and renames it into place, so processes
    building at the same time never load a half-written library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp,
           *(str(s) for s in sources())]
    if verbose:
        cmd.insert(1, '-Xptxas=-v')
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s\n%s' % (
                res.returncode, ' '.join(cmd), res.stderr))
        if verbose:
            print(res.stderr, end='')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def load():
    """The loaded kernel library (built first if needed), with every C
    function's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
