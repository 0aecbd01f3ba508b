"""Build the port's CUDA sources (`csrc/*.cu`) into shared libraries at first
use, and load them with ctypes.

Each source is compiled on its own with nvcc for sm_90a into
`build/misaki_tpu_torch/<stem>_<hash>.so`, the hash taken over the source,
the files it includes by a quoted path, and the flags, so an edited source
is rebuilt and an unchanged one is not.
The libraries have a plain C interface: pointers and the stream go in as
`c_void_p`, and each launch function returns the CUDA error code.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "misaki_tpu_torch"
# -fmad=false: the kernels are held bit for bit against plain PyTorch twins,
# which round every product; a fused multiply-add would not
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(src, seen=None):
    """The bytes of `src` and, once each, of the files it includes by a
    quoted path relative to it."""
    seen = set() if seen is None else seen
    src = src.resolve()
    if src in seen:
        return b""
    seen.add(src)
    data = src.read_bytes()
    return data + b"".join(_source_bytes(src.parent / inc.decode(), seen)
                           for inc in _LOCAL_INCLUDE.findall(data))


def library_path(src):
    """Where the library of source `src` is built: named by the hash of the
    source, its local includes and the flags."""
    src = Path(src)
    h = hashlib.sha256(_source_bytes(src) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def compile_sources(srcs):
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Raises RuntimeError naming each source
    that failed, with the compiler's output. Returns the library paths."""
    paths = [library_path(s) for s in srcs]
    jobs = []
    try:
        for src, so in zip(srcs, paths):
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((src, so, tmp, proc))
        errors = []
        for src, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                errors.append(f"nvcc failed on {src}:\n{out}")
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def compile_all():
    """`compile_sources` of every source in `csrc`: for a process that
    starts others, which then load the libraries they use without each
    running nvcc."""
    return compile_sources(sorted(CSRC.glob("*.cu")))


def load_library(src, signatures):
    """Build (if needed) and load the library of `src`, declaring each
    function of `signatures` = {name: (argtypes, restype)}. Loaded once per
    process."""
    src = Path(src)
    lib = _loaded.get(src)
    if lib is None:
        (so,) = compile_sources([src])
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[src] = lib
    return lib


def check_launch(err, what):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
