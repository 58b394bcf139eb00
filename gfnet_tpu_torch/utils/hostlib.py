"""Host C++ libraries of the port, built at first use.

`data/imageio.py` (`csrc/imageio.cpp`) and `utils/orbax.py` (`csrc/zstd.cpp`)
each compile one plain C++17 source with the host compiler (`$CXX`, else
`c++` or `g++`; `-O3 -shared -fPIC`) into
`gfnet_tpu_torch/_build/<tag>_<hash of source and flags>/` and load it with
`ctypes`, which releases the interpreter lock during a call.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the port builds its host "
                       "libraries (image decoding, checkpoint reading) with one")


def build_library(source: Path, lib_name: str, tag: str) -> Path:
    """Path of `source` built as the shared library `lib_name`, compiled once
    a source hash."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + source.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{tag}_{digest}"
    lib_path = out_dir / lib_name
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{lib_name}.{os.getpid()}"
        proc = subprocess.run([compiler(), *CXX_FLAGS, str(source), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}")
        os.replace(tmp, lib_path)  # a concurrent loader never sees a half-written file
    return lib_path
