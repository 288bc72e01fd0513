"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-Xptxas -v` into `_build/lib<name>-<hash>.so`, then loaded with ctypes. The
hash covers the source, every shared header `csrc/*.cuh` and the flags, so
an edited source or header is rebuilt and a built one is reused. What ptxas
reports per kernel (registers, shared memory, spills) is kept beside the
library as `lib<name>-<hash>.json` and in `BUILD_INFO`. Nothing is built at
import: the first launch of a kernel builds it. Loading a library is the
span `setup.kernel_load.<name>`; each nvcc run counts `setup.nvcc_builds`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict

from .utils.trace import count, span

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# per library, per kernel: what ptxas reported (registers, smem bytes, stack
# frame bytes, spill store and load bytes)
BUILD_INFO: Dict[str, Dict[str, Dict[str, int]]] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc (the CUDA toolkit's compiler) was not found on PATH or at "
            "/usr/local/cuda/bin/nvcc; it is needed to build geometry_rl_torch's "
            "CUDA kernels from csrc/."
        )
    return nvcc


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel, the numbers of nvcc's `-Xptxas -v` report."""
    info: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            kernel = m.group(1)
            info.setdefault(kernel, {})
            continue
        if kernel is None:
            continue
        for key, pattern in (
            ("stack_bytes", r"(\d+) bytes stack frame"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"),
            ("registers", r"Used (\d+) registers"),
            ("smem_bytes", r"(\d+) bytes smem"),
        ):
            m = re.search(pattern, line)
            if m:
                info[kernel][key] = int(m.group(1))
    return info


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its build is missing or stale, and load it."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with span(f"setup.kernel_load.{name}"):
        path = library_path(name)
        info_path = path[: -len(".so")] + ".json"
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {name}.cu:\n{proc.stderr}")
                with open(info_path, "w") as f:
                    json.dump(parse_ptxas(proc.stdout + proc.stderr), f)
                os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            count("setup.nvcc_builds")
        if os.path.exists(info_path):
            with open(info_path) as f:
                BUILD_INFO[name] = json.load(f)
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib
