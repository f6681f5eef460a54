"""Build and load the CUDA kernels of ``rri_nmf_tpu_torch/csrc``.

``nvcc`` compiles each ``csrc/*.cu`` (with the shared header
``csrc/storage.cuh``) into an object, one process per source, all
started together, and links them into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only: ``-gencode arch=compute_90a,code=sm_90a``. The library goes
to ``build/rri_nmf_tpu_torch/`` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing file. The build runs at the first kernel launch,
never at import.

The C functions take raw device pointers and the CUDA stream as
``c_void_p`` and the device index as an int, and return
``cudaGetLastError()`` after their launch; :func:`launch` raises when it
is not 0. (``rri_gs_fits_*`` and ``rri_tm_proj_fits_*`` launch
nothing: each answers, through
:func:`device_fits`, whether its launcher accepts the shape on the device;
``rri_tm_proj_scratch_bytes`` says how much scratch B2's grid barrier
takes, and ``rri_gram_resident_*`` how many teams a Gram launch holds at
once.) :func:`check_operands` is the wrappers' common check of device,
dtype, shape and contiguity.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'rri_nmf_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# (name, argtypes): pointers and the stream as c_void_p — a bare Python
# int would be passed as a 32-bit int and cut the pointer
SIGNATURES = {
    # G, N, F, ub, out; k, m, l1, l2, bound, reps
    'rri_gs_f32': [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P],
    'rri_gs_f64': [_P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _I, _I, _P],
    # G, N, F, out, work, scratch; k, d, l1, l2, s, reps
    'rri_tm_proj_f32': [_P] * 6 + [_I, _I, _F, _F, _F, _I, _I, _P],
    'rri_tm_proj_f64': [_P] * 6 + [_I, _I, _D, _D, _D, _I, _I, _P],
    # bytes of scratch rri_tm_proj takes
    'rri_tm_proj_scratch_bytes': [],
    # k (, d), device: whether B1 (B2) runs at that shape on the device
    'rri_gs_fits_f32': [_I, _I],
    'rri_gs_fits_f64': [_I, _I],
    'rri_tm_proj_fits_f32': [_I, _I, _I],
    'rri_tm_proj_fits_f64': [_I, _I, _I],
    # R, M, dw, t_prev, w, wR0, nw; n, d, cluster
    'rri_masked_phase_a_f32': [_P] * 7 + [_I, _I, _I, _I, _P],
    'rri_masked_phase_a_f64': [_P] * 7 + [_I, _I, _I, _I, _P],
    # R, M, w, w_eff, t_old, t_new, Rt, mt2; n, d
    'rri_masked_phase_b_f32': [_P] * 8 + [_I, _I, _I, _P],
    'rri_masked_phase_b_f64': [_P] * 8 + [_I, _I, _I, _P],
    # Ft, colptr, gidx, vals, out; k, ldf, ncols, ldo
    'rri_sparse_gather_f32': [_P] * 5 + [_I] * 4 + [_I, _P],
    'rri_sparse_gather_f64': [_P] * 5 + [_I] * 4 + [_I, _P],
}
# the 16-bit forms (bfloat16, float16 storage; float32 scalars and sums)
# take the float32 form's arguments
for _name in [n for n in SIGNATURES if n.endswith('_f32')]:
    for _suffix in ('bf16', 'f16'):
        SIGNATURES[_name[:-3] + _suffix] = SIGNATURES[_name]
# the Gram contraction in float32 and float64 only (Γ/Θ are built in the
# accumulation dtype): Ft, gidx, vals, out, items, split_ptr, scratch,
# arrivals; k, ldf, t0, p, ncols, nitems; and the teams a launch holds at
# once: k, t0, p, device
for _suffix in ('f32', 'f64'):
    SIGNATURES['rri_gram_contract_' + _suffix] = [_P] * 8 + [_I] * 7 + [_P]
    SIGNATURES['rri_gram_resident_' + _suffix] = [_I] * 4
# the SpMV in float32 and float64 only: rowptr, cols, vals, blocks, t, out;
# nblocks
for _suffix in ('f32', 'f64'):
    SIGNATURES['rri_spmv_' + _suffix] = [_P] * 6 + [_I, _I, _P]
# the kernels' dtypes: ctypes scalar and C-function suffix
CTYPES = {torch.float32: _F, torch.float64: _D, torch.bfloat16: _F,
          torch.float16: _F}
SUFFIX = {torch.float32: 'f32', torch.float64: 'f64',
          torch.bfloat16: 'bf16', torch.float16: 'f16'}


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
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ('librri_nmf_kernels_%s.so' % h.hexdigest()[:16])


def build(verbose=False):
    """Compile the library if it is not built yet; returns its path.

    One ``nvcc -c`` per source runs at the same time; the objects are
    linked in a temporary directory and the library renamed into place,
    so processes building at the same time never load a half-written
    file."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    flags = NVCC_FLAGS + (['-Xptxas=-v'] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + '.o')
            cmd = [nvcc, *flags, '-c', '-o', obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append('nvcc failed (%d):\n%s\n%s' % (
                    proc.returncode, ' '.join(cmd), err))
            elif verbose:
                print(err, end='')
        if failed:
            raise RuntimeError('\n'.join(failed))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, '-shared', '-Xcompiler', '-fPIC', '-o', lib,
               *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError('nvcc link failed (%d):\n%s\n%s' % (
                res.returncode, ' '.join(cmd), res.stderr))
        os.replace(lib, out)
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


def device_fits(fn, dtype, device, *args):
    """Whether the launcher behind ``fn`` accepts ``args`` in ``dtype`` on
    ``device``: the C function ``<fn>_<suffix>(*args, device_index)``,
    which builds the kernels on the first call. On any device other than
    CUDA the plain twins run, and they have no such limit: True."""
    device = torch.device(device)
    if device.type != 'cuda':
        return True
    if dtype not in SUFFIX:
        return False
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    fits = getattr(load(), '%s_%s' % (fn, SUFFIX[dtype]))(*args, index)
    if fits < 0:
        raise RuntimeError('%s failed: CUDA error %d' % (fn, -fits))
    return bool(fits)


def check_operands(ref, operands):
    """Device/dtype/shape/contiguity checks shared by the kernel wrappers:
    ``ref`` is a CUDA tensor of the kernel's dtype, ``operands`` maps
    names to (tensor, expected shape); each must be a contiguous tensor of
    ``ref``'s dtype on its device. (Device indices are compared as ints:
    the wrappers run it on every launch.)"""
    if not ref.is_cuda:
        raise ValueError('the kernels run on CUDA or (plain twin) CPU '
                         'tensors, got %s' % ref.device)
    dtype = ref.dtype
    if dtype not in CTYPES:
        raise ValueError('the kernels take float32/float64 or 16-bit '
                         'bfloat16/float16, got %s' % dtype)
    index = ref.get_device()
    for name, (a, shape) in operands.items():
        if a.dtype != dtype or not a.is_cuda or a.get_device() != index:
            raise ValueError('%s must be %s on %s, got %s on %s' % (
                name, dtype, ref.device, a.dtype, a.device))
        if tuple(a.shape) != tuple(shape):
            raise ValueError('%s must have shape %s, got %s'
                             % (name, tuple(shape), tuple(a.shape)))
        if not a.is_contiguous():
            raise ValueError('%s must be contiguous' % name)


# PyTorch's current CUDA stream of a device index as a raw handle, without
# building a torch.cuda.Stream (what its own generated code calls); the
# public form where a build lacks it
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(fn, ref, *args):
    """Call the C function ``<fn>_<suffix>`` (:data:`SUFFIX` of ``ref``'s
    dtype) with ``args``, then ``ref``'s device index and PyTorch's
    current stream on it; raise if it reports a CUDA error."""
    index = ref.get_device()
    err = getattr(load(), '%s_%s' % (fn, SUFFIX[ref.dtype]))(
        *args, index, _raw_stream(index))
    if err != 0:
        raise RuntimeError('%s kernel launch failed: CUDA error %d'
                           % (fn, err))
