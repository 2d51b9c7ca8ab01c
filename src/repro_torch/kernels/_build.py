"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (the folded 1D
banded kernels, ``stencil_{banded,sparse}1d``, share
``csrc/line_fold.cuh``, and with the folded 1D tap-sum,
``stencil_direct1d``, ``csrc/line_stage.cuh``; the 2D banded kernels,
``stencil_{banded,sparse}``, share ``csrc/tile_fold.cuh``, which builds
on the 3D ones' ``csrc/slab_fold.cuh``); the four main
kernels' sources compile a second time with ``-DREPRO_FOIL`` into the
libraries of the traffic foils (``<name>_foil``), so instantiating the
foils' staging costs the main path's build nothing, the three 3D
sources a third time with ``-DREPRO_CLUSTER`` into the libraries of their
cluster forms (``<name>_cluster``, ``csrc/cluster.cuh``), and the 2D and
3D tap-sum and fold sources with ``-DREPRO_WORKSPACE`` into the libraries
of their workspace forms (``<name>_workspace``: the same bodies with
their layout in a device workspace, persistent CTAs walking the tiles),
which all compile beside them.  With
``REPRO_COUNT_LOADS=1`` every library builds with ``-DREPRO_COUNT_LOADS``
instead (a name of its own, beside the default build): each CTA then
counts the cells its staging loads -- a foil's windows, a default
kernel's region, the 1D kernels per segment or CTA tile -- and
``repro_load_counts`` returns the least and the most count over a
launch's CTAs (``csrc/common.cuh``; ``chip_smoke.py`` checks them
against the analytic count and the auditor's, ``repro_torch.audit``).
The default build compiles the counts away.  The build runs at
first use into ``build/repro_torch/`` under the checkout, named by a hash
of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  :func:`build_all` starts one ``nvcc`` per
library together.  A missing ``nvcc`` or a failed build raises.

Every kernel wrapper adds one to its entry of the launch counts for each
launch of its kernel, and nowhere else (a batch past gridDim.z's limit
launches in chunks, ``common.batch_chunks``); a foil launch counts under
``<kernel> (<staging>)``, a cluster form's launch (a 3D layout past one
CTA, ``common.ClusterLayout``) under ``<kernel> (cluster)``, a workspace
form's (a layout no CTA or cluster holds, ``common.WorkspaceLayout``)
under ``<kernel> (workspace)``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

from repro_torch.core.envutil import env_flag

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MAIN = ("stencil_direct", "stencil_banded", "stencil_direct3d",
         "stencil_banded3d", "stencil_sparse", "stencil_sparse3d",
         "stencil_banded1d", "stencil_sparse1d", "stencil_direct1d")
_FOILED = _MAIN[:4]
#: The 3D kernels whose cluster forms (csrc/cluster.cuh: a layout past
#: one CTA spread over a thread-block cluster) build apart, from the same
#: sources with -DREPRO_CLUSTER, and count apart.
CLUSTERED = ("stencil_direct3d", "stencil_banded3d", "stencil_sparse3d")
#: The 2D and 3D kernels whose workspace forms (the tile rule's fourth
#: rung: a layout no CTA or cluster holds, in a device workspace) build
#: apart, from the same sources with -DREPRO_WORKSPACE, and count apart.
WORKSPACED = ("stencil_direct", "stencil_banded", "stencil_sparse",
              "stencil_direct3d", "stencil_banded3d", "stencil_sparse3d")
#: Every library: the main kernels, the foils', the cluster forms' and
#: the workspace forms' builds of their sources.
KERNELS = (_MAIN + tuple(f"{k}_foil" for k in _FOILED)
           + tuple(f"{k}_cluster" for k in CLUSTERED)
           + tuple(f"{k}_workspace" for k in WORKSPACED))
#: Launch counters: one per main kernel, one per foil kernel and staging
#: (the 9-tile foil is 2D only), one per cluster form,
#: ``<kernel> (cluster)``, and one per workspace form,
#: ``<kernel> (workspace)``.
COUNTERS = _MAIN + tuple(
    f"{k} ({st})" for k in _FOILED
    for st in (("wholestrip", "9tile") if not k.endswith("3d")
               else ("wholeslab",))) + tuple(
    f"{k} (cluster)" for k in CLUSTERED) + tuple(
    f"{k} (workspace)" for k in WORKSPACED)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNTS: collections.Counter = collections.Counter()
_CTAS: Dict[str, int] = {}

#: nvcc's diagnostics (ptxas register and shared-memory report) of the
#: builds this process ran, by kernel name.
build_logs: Dict[str, str] = {}

#: Wall seconds from the start of each build this process ran to its end.
build_seconds: Dict[str, float] = {}


def count_launch(name: str, n: int = 1, ctas: int = None) -> None:
    """Count ``n`` launches of ``name`` (a batch past gridDim.z's limit
    launches in chunks: ``common.batch_chunks``); a cluster form's launch
    also gives the CTAs of its cluster, ``ctas``."""
    _COUNTS[name] += n
    if ctas is not None:
        _CTAS[name] = ctas


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: _COUNTS[name] for name in COUNTERS}


def cluster_ctas() -> Dict[str, int]:
    """The CTAs a tile of each cluster form's last launch since the last
    :func:`reset_launch_counts`, by counter."""
    return dict(_CTAS)


def reset_launch_counts() -> None:
    _COUNTS.clear()
    _CTAS.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "src/repro_torch/kernels/csrc at first use and need the CUDA "
        "toolkit on PATH (or under /usr/local/cuda)")


#: Suffixes of the libraries built a second time from a main source, and
#: the define each adds.
_BUILDS = {"_foil": "-DREPRO_FOIL", "_cluster": "-DREPRO_CLUSTER",
           "_workspace": "-DREPRO_WORKSPACE"}


def source(name: str) -> str:
    """The source library ``name`` builds from (``csrc/<source>.cu``)."""
    for suffix in _BUILDS:
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def _flags(name: str) -> tuple:
    extra = tuple(d for suffix, d in _BUILDS.items() if name.endswith(suffix))
    count = env_flag("REPRO_COUNT_LOADS", False)
    return NVCC_FLAGS + extra + (("-DREPRO_COUNT_LOADS",) if count else ())


def _target(name: str) -> pathlib.Path:
    """The library path of ``name``, keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in [CSRC / f"{source(name)}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: pathlib.Path) -> subprocess.Popen:
    """Start nvcc on ``name``; its diagnostics go to a log file beside the
    library (a pipe nobody reads while the others build could fill)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
           str(CSRC / f"{source(name)}.cu")]
    with open(out.with_suffix(f".{os.getpid()}.log"), "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _finish(name: str, out: pathlib.Path, proc: subprocess.Popen) -> None:
    proc.wait()
    log_path = out.with_suffix(f".{os.getpid()}.log")
    log = log_path.read_text()
    log_path.unlink()
    build_logs[name] = log
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source(name)}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> None:
    """Build every kernel not yet built, one ``nvcc`` per source started
    together, and load them."""
    with _LOCK:
        pending = {n: _target(n) for n in names if n not in _LIBS}
        t0 = time.perf_counter()
        procs = {n: _start(n, out) for n, out in pending.items()
                 if not out.exists()}
        errors = []
        while procs:                    # finish each as it ends, timed
            done = [n for n, proc in procs.items() if proc.poll() is not None]
            for n in done:
                build_seconds[n] = time.perf_counter() - t0
                try:
                    _finish(n, pending[n], procs.pop(n))
                except RuntimeError as e:   # finish the others, then report
                    errors.append(str(e))
            if not done:
                time.sleep(0.05)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, out in pending.items():
            lib = ctypes.CDLL(str(out))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            _LIBS[n] = lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name]
    return lib


def c_ints(values) -> ctypes.Array:
    """``values`` as a C ``int`` array, as the C entries take a cluster's
    split bounds (``common.ClusterLayout.split`` / ``.rows``)."""
    return (ctypes.c_int * len(values))(*values)


def check(err: int, name: str) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error."""
    if err != 0:
        lib = library(name)
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
