"""Build and load the port's CUDA kernels.

Each source under `ops/csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, `build/kernels/<name>-<hash>.so`
at the root of the checkout (or under `DET_KERNEL_DIR`), and loaded with
`ctypes`. The hash covers the source and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. The build happens at first
use, never at import: the CPU tests import every module on a host without
`nvcc`.

A library resolves in this order (docs/compile-farm-torch.md):

  1. the kernel directory on disk;
  2. the compile farm, when a `FarmClient` is given (or set for the process
     with `set_farm`): the signature's artifact is written atomically into
     the kernel directory and loaded, with no `nvcc` call;
  3. `nvcc`, whose fresh library is handed to the farm for a background
     upload.

A fetched library that fails to load is logged and rebuilt with `nvcc`: the
same hand-written kernel either way. Without an artifact and without a
working `nvcc` the load raises, as it always has; nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
TARGET_ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={TARGET_ARCH}", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Every library the port builds: one a source under csrc/.
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

logger = logging.getLogger("determined_tpu_torch.ops")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when it was
# already on disk or came from the farm), and nvcc's output (ptxas register
# and spill counts).
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}
# Where each library of this process came from: "disk", "farm" or "nvcc".
sources: Dict[str, str] = {}
# The farm `load` resolves through when its caller passes none, and
# whether fresh builds are uploaded to it (set_farm).
_farm: Any = None
_upload = True


def kernel_dir() -> Path:
    """Where libraries are built and fetched to: `DET_KERNEL_DIR`, else
    build/kernels at the root of the checkout."""
    env = os.environ.get("DET_KERNEL_DIR")
    return Path(env) if env else BUILD_DIR


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels cannot be built on this host")
    return found


def digest(name: str) -> str:
    """The hash of `csrc/<name>.cu` and the flags it is built with."""
    src = CSRC / f"{name}.cu"
    return hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]


def library_path(name: str) -> Path:
    return kernel_dir() / f"{name}-{digest(name)}.so"


def artifact_name(name: str) -> str:
    """The farm's name for the library: `aot-kernel_<name>-<hash>-<tag>.bin`
    (the agent prewarms `aot-` files into the node's AOT directory)."""
    from determined_tpu_torch.compile.runtime import aot_artifact_name

    return aot_artifact_name(f"kernel_{name}-{digest(name)}")


def artifacts(name: str) -> Dict[str, bytes]:
    """{artifact name: the library's bytes} for an upload."""
    return {artifact_name(name): library_path(name).read_bytes()}


def set_farm(client: Any, upload: bool = True) -> Any:
    """Resolve this process's libraries through `client` (None: none);
    -> the previous client."""
    global _farm, _upload
    previous, _farm, _upload = _farm, client, upload
    return previous


def write_atomic(out: Path, data: bytes) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def compile_library(name: str, out: Path) -> float:
    """`nvcc` `csrc/<name>.cu` into `out` (atomically); -> seconds."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.monotonic() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{build_log[name]}")
    os.replace(tmp, out)
    return secs


def _nvcc(name: str, out: Path, farm: Any) -> None:
    build_seconds[name] = compile_library(name, out)
    sources[name] = "nvcc"
    if farm is not None and farm.enabled and _upload:
        farm.upload_async(artifacts(name),
                          compile_ms=build_seconds[name] * 1e3)


def build(name: str, farm: Any = None) -> Path:
    """The library for `csrc/<name>.cu`: on disk, else fetched from the
    farm, else compiled."""
    farm = farm if farm is not None else _farm
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        sources.setdefault(name, "disk")
        return out
    if farm is not None and farm.enabled:
        data = farm.fetch(artifact_name(name))
        if data is not None:
            write_atomic(out, data)
            build_seconds[name] = 0.0
            sources[name] = "farm"
            return out
    _nvcc(name, out, farm)
    return out


def load(name: str, farm: Any = None) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, resolved on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name, farm)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                if sources.get(name) != "farm":
                    raise
                logger.warning("the farm's %s library failed to load (%s); "
                               "rebuilding it with nvcc", name, e)
                path.unlink(missing_ok=True)
                try:
                    _nvcc(name, path, farm if farm is not None else _farm)
                except RuntimeError as err:
                    raise RuntimeError(
                        f"the farm's {name} library failed to load ({e}) "
                        f"and cannot be rebuilt: {err}") from err
                lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def nvcc_built() -> Dict[str, float]:
    """{library: seconds} of what `nvcc` built in this process."""
    return {n: build_seconds[n] for n, s in sources.items() if s == "nvcc"}
