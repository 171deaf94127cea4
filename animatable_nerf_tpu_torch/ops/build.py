"""Build the hand-written CUDA kernels of csrc/ with nvcc.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `build/lib<name>.so` at the checkout root (bound with ctypes by its
ops/ module) at first use; the compiler's output, with ptxas's register
and shared-memory report, goes to `build/<name>.build.log`. Several
sources build in parallel, one nvcc process each.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> str:
    return (BUILD_DIR / f"{name}.build.log").read_text()


def build_libraries(names) -> list:
    """Compile csrc/<name>.cu into build/lib<name>.so for every name
    whose library is missing or older than its source, all nvcc
    processes at once. Returns the library paths; raises if any build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = CSRC_DIR / f"{name}.cu", library_path(name)
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.build.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(name) for name in names]


def build_library(name: str) -> Path:
    return build_libraries([name])[0]
