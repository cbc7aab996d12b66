"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/lib<name>.so`` with a plain ``extern "C"`` interface, loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v --split-compile 0 \\
         -o build/lib<name>.so csrc/<name>.cu

``--split-compile 0`` lets the compiler optimize a source's kernels on
every core at once (a source holds dozens of template instances).

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them; a library is rebuilt when its source, or a header of ``csrc/``
(``split_kv.cuh``, which the split-KV kernels share), is newer.
``ptxas``' register and shared-memory report is kept beside each library
as ``build/<name>.ptxas.txt``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNELS = ("flash_prefill", "fused_decode", "paged_attn")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0"]

_lock = make_lock("ops.build")
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
            "build only where the CUDA toolkit is installed")
    return path


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    sources = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return out.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names=KERNELS) -> list[str]:
    """Compile every stale kernel library, one ``nvcc`` process per source,
    all started together.  Returns the names built; raises
    ``KernelBuildError`` with the compiler's output if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise KernelBuildError("\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
