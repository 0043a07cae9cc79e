"""Build a CUDA source of the port into a shared library with a plain C
interface and load it with ``ctypes``.

Every hand-written kernel library of the port goes through this one
helper: ``nvcc`` compiles the source at first use, under
``build/repro_torch/`` at the repository root (ignored by git), into
``lib<name>_<hash>.so`` where the hash covers the source and the flags, so
an edited source or a changed flag builds anew and an unchanged one is
loaded as it is. Every build asks ``ptxas`` for its register and spill
report (``-Xptxas -v``, which changes nothing in the binary) and keeps it
beside the library as ``lib<name>_<hash>.ptxas.txt``, so a library that
was built earlier still has its report. A failed build raises
``RuntimeError`` carrying the compiler's output; nothing falls back to a
plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "repro_torch"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # torch looks at $CUDA_HOME, $CUDA_PATH and the toolkit's usual place
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "cannot build the CUDA kernels: no nvcc on PATH or under torch's "
        "CUDA_HOME")


class NvccLibrary:
    """One source file built with fixed flags into one shared library.

    ``build()`` compiles unless the library for this source and these
    flags exists; ``load()`` builds if needed and returns the
    ``ctypes.CDLL`` (loaded once per process). After ``build()``,
    ``ptxas_log`` holds the library's ``-Xptxas -v`` report, from this
    compile or read back from the one that built it (``None`` only for a
    library whose report is missing)."""

    def __init__(self, source: Path, flags: Tuple[str, ...], name: str):
        self.source = Path(source)
        self.flags = tuple(flags)
        self.name = name
        self.ptxas_log: Optional[str] = None
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        """Where the built library for the current source and flags lives."""
        h = hashlib.sha256()
        h.update(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return build_dir() / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def report_path(self) -> Path:
        """Where the ``ptxas`` report of that library is kept."""
        return self.path().with_suffix(".ptxas.txt")

    def build(self) -> Path:
        """Compile unless already built. Raises ``RuntimeError`` carrying
        nvcc's output when the build fails."""
        out, report = self.path(), self.report_path()
        if out.exists():
            self.ptxas_log = (report.read_text() if report.exists()
                              else None)
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *self.flags, "-Xptxas", "-v",
               "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building "
                f"{self.source.name}:\n{' '.join(cmd)}\n{proc.stdout}\n"
                f"{proc.stderr}")
        self.ptxas_log = proc.stderr.strip()
        # the report lands first: a library that exists has its report
        tmp_report = report.with_suffix(f".tmp{os.getpid()}.txt")
        tmp_report.write_text(self.ptxas_log)
        os.replace(tmp_report, report)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        return self._lib
