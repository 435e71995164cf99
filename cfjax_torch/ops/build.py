"""Build and load the port's CUDA kernel libraries.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, `build/lib<name>_<digest>.so` at the
checkout root, and loaded with ctypes. The digest hashes every file under
`csrc/` (sources and the shared headers), so a change to any of them
rebuilds every library. `build()` starts one nvcc per missing library,
all at once, and waits for them; the compiler's resource report
(-Xptxas -v) is kept beside each library as `.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARIES = ("gramian_mvm", "expand_mvm", "grad_mvm", "tile_ell_mvm")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at "
                           "first use and need the CUDA toolkit")
    return found


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.is_file():
            h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_digest()}.so"


def build(names=LIBRARIES) -> None:
    """Compile every library of `names` that is not built yet, one nvcc
    per source, all started together."""
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    failed = []
    for so, tmp, proc in procs:
        out, err = proc.communicate()
        so.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{so.name}: nvcc exit {proc.returncode}\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
