"""
Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
sources are compiled together (one ``nvcc`` process each, all started at
once) at first use, into ``build/gordo_tpu_torch/<hash>/`` beside the
package; a source named in ``PARTS`` is compiled as that many translation
units at once (``-DGORDO_PART=0..n-1``, each holding a share of its
kernels) and linked into its one library. ``<hash>`` covers the sources,
the headers they include (``csrc/*.cuh``) and the flags: a changed source
or header builds anew, an unchanged tree is loaded as built. A failed
build raises with the compiler's output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gordo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# sources compiled in parts: the number of parts (see each source's header)
PARTS = {"lstm_recurrence": 9, "flash_attention_bf16": 2, "flash_attention_bwd_bf16": 4}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# per source: the compiler's output of the build that made its library
# (register and shared-memory use, from -Xptxas -v); empty when loaded as built
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _build_dir() -> Path:
    """The build directory: a hash of the flags and of every source and
    header in ``csrc`` (``*.cu`` and the ``*.cuh`` they include)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(PARTS.items())).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built; return ``{stem: library path}``.

    Each library is written under a temporary name of its process and
    thread and renamed into place, so a concurrent builder never loads a
    half-written file."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in CSRC.glob("*.cu")}
    nvcc = nvcc_path()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = {}  # stem: (library, its temporary file, [(process, object file or None)])
    for stem, lib in libs.items():
        if lib.exists():
            continue
        src = str(CSRC / f"{stem}.cu")
        tag = f"{os.getpid()}-{threading.get_ident()}"
        tmp = lib.with_suffix(f".tmp-{tag}.so")
        if stem in PARTS:
            objs = [lib.with_suffix(f".part{i}.tmp-{tag}.o") for i in range(PARTS[stem])]
            cmds = [[nvcc, *compile_flags, "-c", f"-DGORDO_PART={i}", "-o", str(obj), src]
                    for i, obj in enumerate(objs)]
        else:
            objs, cmds = [None], [[nvcc, *NVCC_FLAGS, "-o", str(tmp), src]]
        jobs[stem] = (lib, tmp, [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), obj)
                                 for cmd, obj in zip(cmds, objs)])
    failures = []
    for stem, (lib, tmp, procs) in jobs.items():
        logs, objs, before = [], [obj for _, obj in procs if obj is not None], len(failures)
        for proc, _ in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{logs[-1]}")
        if objs and len(failures) == before:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failures.append(f"nvcc failed to link {stem} ({link.returncode}):\n{link.stdout}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        BUILD_LOGS[stem] = "".join(logs)
        if len(failures) == before:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building all
    sources first if needed."""
    with _lock:
        if stem not in _libraries:
            libs = build_all()
            if stem not in libs:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            _libraries[stem] = ctypes.CDLL(str(libs[stem]))
        return _libraries[stem]
