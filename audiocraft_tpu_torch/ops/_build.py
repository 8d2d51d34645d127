"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and the objects link into one shared library
with a plain C interface.  The library goes into ``_build/`` beside the
package, named by a hash of the sources, the headers (``csrc/*.cuh``) and the
flags, so a changed source or header builds anew and an unchanged one is
loaded as it is.  Nothing is built or loaded at import time: the first kernel
launch does it, so the package imports on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: every pointer and the stream are void*, every size an int,
# every stride a long long; each launch returns cudaGetLastError() as an int.
_SIGNATURES = {
    'acx_rvq_encode': ([*[_P] * 5, _I, _I, _I, _I, ctypes.POINTER(_I), _P], _I),
    'acx_rvq_encode_clocks': ([*[_P] * 5, _I, _I, _I, _I, ctypes.POINTER(_I), _P, _P], _I),
    'acx_rvq_info': ([_I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
    'acx_rvq_max_dim': ([], _I),
    'acx_lstm_layer': ([*[_P] * 7, *[_I] * 11, _L, _P], _I),
    'acx_lstm_device': ([ctypes.POINTER(_I)], _I),
    'acx_lstm_info': ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    'acx_attention_fwd': ([_P, _P, _P, _P, _P, _I, _I, _I, _I, *[_L] * 9, _F, _I, _I, _P],
                          _I),
    'acx_attention_fwd_info': ([_I, _I, ctypes.POINTER(_I)], _I),
    'acx_attention_bwd_dkv': ([*[_P] * 8, _I, _I, _I, _I, *[_L] * 12, _F, _I, _I, _P], _I),
    'acx_attention_bwd_dq': ([*[_P] * 7, _I, _I, _I, _I, *[_L] * 12, _F, _I, _I, _P], _I),
    'acx_attention_bwd_info': ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    'acx_attention_max_dim': ([], _I),
    'acx_seanet_stage': ([*[_P] * 8, *[_I] * 8, ctypes.POINTER(_I), _P], _I),
    'acx_seanet_stage_clocks': ([*[_P] * 8, *[_I] * 8, ctypes.POINTER(_I), _P, _I, _P], _I),
    'acx_seanet_stage_info': ([*[_I] * 8, ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
    'acx_mono_conv': ([_P, _P, _P, _P, *[_I] * 7, ctypes.POINTER(_I), _P], _I),
    'acx_probe_gather': ([_P, _P, _I, _I, _L, _L, _I, _P], _I),
    'acx_probe_contract': ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    'acx_error_string': ([_I], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when an earlier build with the same hash was reused
    log: str         # nvcc's output, ptxas register and shared-memory report


def _nvcc() -> str:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not Path(nvcc).is_file():
        raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                           'CUDA toolkit on the machine with the card')
    return nvcc


def source_tag() -> str:
    """The hash that names a build: the flags, ``csrc/*.cu`` and the headers
    they include, ``csrc/*.cuh``."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob('*.cu')) + sorted(SOURCE_DIR.glob('*.cuh')):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


@functools.cache
def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless a library for these sources and headers
    exists."""
    sources = sorted(SOURCE_DIR.glob('*.cu'))
    tag = source_tag()
    lib = BUILD_DIR / f'libacx_kernels_{tag}.so'
    if lib.is_file():
        return BuildResult(lib, 0.0, '')
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    objects = [BUILD_DIR / f'{src.stem}_{tag}.o' for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src.name}:\n{log}')
    tmp = lib.with_suffix('.tmp')
    link = subprocess.run([nvcc, '-shared', '-o', str(tmp), *map(str, objects)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
    tmp.replace(lib)
    return BuildResult(lib, time.perf_counter() - start, ''.join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, with argument and result types declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().acx_error_string(err).decode()
        raise RuntimeError(f'{what} failed to launch: CUDA error {err} ({msg})')
