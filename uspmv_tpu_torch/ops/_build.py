"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` of this package is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
ctypes: one nvcc per source, all started together, then one link, so the
build takes about as long as its slowest source. The build runs at first use, into ``build/uspmv_tpu_torch/`` at the
root of the checkout, under a name that carries a hash of the flags, the
sources and the headers they share (``csrc/*.cuh``), so a changed source or
header rebuilds and an unchanged tree loads at once.
No nvcc, or a failed build, raises: nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from ..runtime import profiling

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uspmv_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an earlier build of the same sources was loaded
    build_seconds: float
    log: str  # nvcc's output, ptxas register/shared-memory report included
    # seconds of each source's nvcc (all run at once) and of the link
    step_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


_loaded: Optional[KernelLibrary] = None


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "uspmv_tpu_torch are built from source and need the CUDA toolkit"
    )


def compile_command(source: Path, obj: Path) -> list:
    """The nvcc call that compiles ``source`` into the object ``obj``."""
    return [find_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(objects: list, out: Path) -> list:
    """The nvcc call that links ``objects`` into the library ``out``."""
    return [find_nvcc(), "-shared", "-o", str(out), *map(str, objects)]


def _timed_run(cmd: list) -> tuple:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def compile_library(sources: list, out: Path) -> tuple:
    """Build ``sources`` into the library ``out``: one nvcc per source, all
    started together, into objects beside ``out``, then one link; the
    objects are removed after it. Returns (nvcc's output, seconds per
    source and of the link). Raises KernelBuildError if a step fails."""
    objdir = out.with_name(f"{out.name}.obj")
    objdir.mkdir(parents=True, exist_ok=True)
    objects = [objdir / f"{src.stem}.o" for src in sources]
    try:
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            runs = list(pool.map(_timed_run, [
                compile_command(src, obj)
                for src, obj in zip(sources, objects)]))
        log = "".join(text for _, text, _ in runs)
        seconds = {src.name: s for src, (_, _, s) in zip(sources, runs)}
        failed = [(src, rc) for src, (rc, _, _) in zip(sources, runs) if rc]
        if failed:
            raise KernelBuildError(
                "nvcc failed on "
                + ", ".join(f"{src.name} (rc {rc})" for src, rc in failed)
                + f"\n{log}")
        rc, text, seconds["link"] = _timed_run(link_command(objects, out))
        log += text
        if rc != 0:
            raise KernelBuildError(f"nvcc link failed (rc {rc})\n{log}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return log, seconds


def kernel_resources(library: Path) -> List[dict]:
    """Per kernel of a built library, as ``cuobjdump -res-usage`` reports
    it: the function (demangled by c++filt where it is installed),
    registers per thread, stack, static shared and local memory in bytes
    (local memory > 0: registers spilled), and the instructions of its
    SASS (``cuobjdump -sass``; two builds of one kernel with the same
    count and registers compiled to the same code, as a rule)."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(library)],
                          capture_output=True, text=True, check=True).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:(\d+) LOCAL:(\d+)", text)
    sizes = sass_instructions(subprocess.run(
        [str(tool), "-sass", str(library)], capture_output=True, text=True,
        check=True).stdout)
    names = [f[0] for f in found]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return [dict(function=name, registers=int(reg), stack=int(stack),
                 shared=int(shared), local=int(local),
                 sass_instructions=sizes.get(mangled))
            for name, (mangled, reg, stack, shared, local)
            in zip(names, found)]


def sass_instructions(sass: str) -> Dict[str, int]:
    """Instructions per function of ``cuobjdump -sass`` output: the lines
    that open with an address, ``/*0a40*/``, after its ``Function :``."""
    sizes: Dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            sizes[name] = 0
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def _sources() -> list:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def _digest(sources: list) -> str:
    """Hash of the flags, the sources and the headers they share."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> KernelLibrary:
    """The compiled kernel library, built on first use in this process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = _sources()
    out = BUILD_DIR / f"libuspmv_tpu_torch_{_digest(sources)}.so"
    built, seconds, log, steps = False, 0.0, "", {}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builds
        # never load a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            with profiling.span("kernels.build"):
                log, steps = compile_library(sources, tmp)
        except KernelBuildError:
            tmp.unlink(missing_ok=True)
            raise
        seconds = time.perf_counter() - t0
        os.replace(tmp, out)
        built = True
    _loaded = KernelLibrary(
        lib=ctypes.CDLL(str(out)), path=out, built=built,
        build_seconds=seconds, log=log, step_seconds=steps,
    )
    return _loaded
