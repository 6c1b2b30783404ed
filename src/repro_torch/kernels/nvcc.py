"""Building and loading the port's CUDA sources: ``nvcc`` by hand into a
shared library with a plain C interface, cached under ``build/repro_torch/``
at the root of the checkout by a hash of the source and flags (so an edit
rebuilds), loaded with ``ctypes`` by :func:`load`.  Nothing is built
until a kernel's first use.

Every source exports ``<prefix>_geometry`` (its compile-time constants,
which the wrapper's must equal) and ``<prefix>_error_string`` (the text of
a nonzero code its entry points return); a wrapper declares only its own
launches."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence, Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"nvcc not found under {home} or on PATH")


def build_library(source: pathlib.Path, stem: str,
                  flags: Sequence[str] = NVCC_FLAGS,
                  build_dir: pathlib.Path = BUILD_DIR
                  ) -> Tuple[pathlib.Path, str]:
    """Compile ``source`` with ``flags`` into ``build_dir/<stem>_<hash>.so``
    (the hash of the source and flags) unless it is already built.

    Returns (library path, compiler output); the output holds ptxas's
    register and shared-memory report, and is empty when nothing was built.
    """
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = build_dir / f"{stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib, proc.stdout + proc.stderr


def load(path: pathlib.Path, source: pathlib.Path, prefix: str,
         geometry: Sequence[int]) -> ctypes.CDLL:
    """The library at ``path``, built from ``source`` by
    :func:`build_library`, loaded, with ``check(err, what)``: the one test
    of the codes its entry points return.

    Loading declares ``<prefix>_geometry`` and ``<prefix>_error_string`` and
    raises unless the library's geometry is ``geometry``, the wrapper's
    constants: a stale or edited source never runs under a wrapper that
    plans its launches otherwise."""
    lib = ctypes.CDLL(str(path))
    read = getattr(lib, f"{prefix}_geometry")
    read.argtypes = [ctypes.POINTER(ctypes.c_int)]
    read.restype = None
    error_string = getattr(lib, f"{prefix}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * len(geometry))()
    read(got)
    if tuple(got) != tuple(geometry):
        raise RuntimeError(f"{source.name} has geometry {tuple(got)}, "
                           f"the wrapper {tuple(geometry)}")

    def check(err: int, what: str) -> None:
        """Raise if ``err``, the code an entry point returned, is nonzero."""
        if err != 0:
            raise RuntimeError(f"{what} failed: "
                               f"{error_string(err).decode()} ({err})")

    lib.check = check
    return lib
