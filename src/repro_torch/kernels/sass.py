"""The SASS of the port's CUDA libraries, read with ``cuobjdump``.

:func:`functions` gives each kernel instantiation's instructions,
:func:`registers` its register count, :func:`stack_bytes` its stack frame.  Run as a script, the module
compares the kernels of this checkout (every library of
``_build.KERNELS``: the main builds and the foils') with those of
another checkout of the repository, both built here with this
checkout's ``nvcc`` flags, instantiation by instantiation::

    python -m repro_torch.kernels.sass OTHER_CHECKOUT [DIFF_FILE]

For each instantiation it prints whether the instructions are identical
and, where not, how many differ and the registers of each, and writes
the differing instructions as a unified diff to DIFF_FILE; an
instantiation of this checkout whose last template argument is the
staging code 0 (``STAGE_REGION``, ``csrc/common.cuh``) is matched to the
other checkout's instantiation without that argument, and instantiations
are matched by their template arguments whatever their parameters.
A library the other checkout lacks (its source, or for a second build of
a source the define that build adds, such as ``REPRO_WORKSPACE``) is
listed, with its instantiations' registers, as new.  Needs ``nvcc``
and ``cuobjdump``, not a card.
"""
from __future__ import annotations

import difflib
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

from . import _build

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def cuobjdump() -> str:
    """The ``cuobjdump`` beside ``nvcc``; raises if there is none."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool})")
    return tool


def functions(lib: os.PathLike) -> Dict[str, List[str]]:
    """Mangled name -> instruction texts (no addresses, no encodings) of
    every kernel in the library ``lib``."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    fns: Dict[str, List[str]] = {}
    fn = None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fns[fn] = []
        elif fn is not None:
            m = _INSTR.search(line)
            if m:
                fns[fn].append(m.group(1))
    return fns


def _usage(lib: os.PathLike, key: str) -> Dict[str, int]:
    """Mangled name -> the resource ``key`` of ``cuobjdump -res-usage``
    ("REG", "STACK", ...) of every kernel in ``lib``."""
    out = subprocess.run([cuobjdump(), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    vals, fn = {}, None
    for line in out.splitlines():
        if "Function " in line:
            fn = line.split("Function ")[1].strip().rstrip(":")
        m = re.search(rf"\b{key}:(\d+)", line)
        if fn is not None and m:
            vals[fn] = int(m.group(1))
            fn = None
    return vals


def registers(lib: os.PathLike) -> Dict[str, int]:
    """Mangled name -> registers per thread of every kernel in ``lib``."""
    return _usage(lib, "REG")


def stack_bytes(lib: os.PathLike) -> Dict[str, int]:
    """Mangled name -> bytes of stack frame per thread of every kernel in
    ``lib``: the spills, for kernels with no local arrays."""
    return _usage(lib, "STACK")


def _build_lib(src: pathlib.Path, out: pathlib.Path, flags: tuple) -> pathlib.Path:
    subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    return out


def _targs(name: str) -> str:
    """A kernel's mangled name up to the end of its template arguments
    (every kernel's last template argument is a literal, so ``EEv``
    closes them); the parameter list after it may differ between
    checkouts (the batch's grid size came as a parameter, K11)."""
    i = name.find("EEv")
    return name if i < 0 else name[:i + 3]


def _twin(name: str, others: Dict[str, List[str]]) -> str:
    """The other checkout's name of this checkout's instantiation: the
    same template arguments, with or without the staging code 0."""
    if name in others:
        return name
    by_targs = {_targs(n): n for n in others}
    for cand in (name, name.replace("Li0EEv", "Ev")):
        if _targs(cand) in by_targs:
            return by_targs[_targs(cand)]
    return name


def _builds(root: pathlib.Path, name: str) -> bool:
    """Whether the checkout whose sources are under ``root`` has library
    ``name``: its source, and for a second build of it (``_foil``,
    ``_cluster``, ``_workspace``) the define that build adds."""
    src = root / f"{_build.source(name)}.cu"
    if not src.exists():
        return False
    extra = [d[2:] for d in _build._flags(name) if d.startswith("-DREPRO_")
             and d != "-DREPRO_COUNT_LOADS"]
    text = src.read_text()
    return all(d in text for d in extra)


def main(argv: List[str]) -> int:
    if len(argv) not in (1, 2):
        print(__doc__)
        return 2
    other = pathlib.Path(argv[0]).resolve() / "src/repro_torch/kernels/csrc"
    out = _build.BUILD_DIR / "sass"
    out.mkdir(parents=True, exist_ok=True)
    diffs: List[str] = []
    jobs = {(side, k): (root / f"{_build.source(k)}.cu", out / f"{side}-{k}.so",
                        _build._flags(k))
            for side, root in (("this", _build.CSRC), ("other", other))
            for k in _build.KERNELS if _builds(root, k)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: _build_lib(*j),
                                       jobs.values())))
    same = total = 0
    for k in _build.KERNELS:
        if ("other", k) not in libs:
            for name, n in sorted(registers(libs["this", k]).items()):
                print(f"{k}: {name}: new in this checkout, {n} registers")
            continue
        ours, theirs = functions(libs["this", k]), functions(libs["other", k])
        r_ours, r_theirs = registers(libs["this", k]), registers(libs["other", k])
        for name in sorted(ours):
            twin = _twin(name, theirs)
            total += 1
            if twin not in theirs:
                print(f"{k}: {name}: no twin in the other checkout")
                continue
            a, b = theirs[twin], ours[name]
            if a == b:
                same += 1
                print(f"{k}: {name}: identical, {len(b)} instructions, "
                      f"{r_ours.get(name)} registers")
                continue
            diffs += difflib.unified_diff(a, b, twin, name, n=2, lineterm="")
            changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in
                          difflib.SequenceMatcher(None, a, b, autojunk=False)
                          .get_opcodes() if tag != "equal")
            print(f"{k}: {name}: DIFFERS, {len(a)} -> {len(b)} instructions, "
                  f"{changed} changed; registers {r_theirs.get(twin)} -> "
                  f"{r_ours.get(name)}")
    print(f"{same} of {total} instantiations identical")
    if len(argv) == 2:
        pathlib.Path(argv[1]).write_text("\n".join(diffs) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
