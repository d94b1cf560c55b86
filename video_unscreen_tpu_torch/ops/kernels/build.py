"""Build and load the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` sources compile in ONE `nvcc` call into one shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, no
`torch.utils.cpp_extension`: the library builds in seconds). The build
happens at first use, into `video_unscreen_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the sources and flags, so a source edit
rebuilds and an unchanged tree reuses the library. Nothing here runs at
import time: the CPU tests import every module without `nvcc` or a card.
`python -m video_unscreen_tpu_torch.ops.kernels.build` builds and prints
what `ptxas -v` says of each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (argtypes); every entry returns a cudaError_t as int and
# writes the number of kernels it launched through its last argument
_SIGNATURES = {
    "vut_morph": (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P),
    "vut_trimap": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P),
    "vut_flood": (_P, _P, _P, _P, _I, _I, _P, _P),
    "vut_flood_phases": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "vut_attention_tiles": (_P, _P, _P, _I, _I, _P, _P),
    "vut_attention": (_P,) * 8 + (_I,) * 5 + (_P, _P),
    "vut_attention_bwd_dq": (_P,) * 11 + (_I,) * 6 + (_P, _P),
    "vut_attention_bwd_dkv": (_P,) * 9 + (_I,) * 8 + (_P, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "video_unscreen_tpu_torch/csrc need the CUDA toolkit to build")


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    """Where the library for the current sources (and `defines`) lives,
    built or not."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvut_kernels_{h.hexdigest()[:16]}.so"


def build(defines: Tuple[str, ...] = ()) -> Path:
    """Compile `csrc/*.cu` unless the library for these sources exists.
    `defines` (`-DNAME=VALUE` flags) build a variant for a diagnostic, under
    its own name; the library the wrappers load has none."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    # compile to a private name, then rename: a concurrent build or a build
    # cut short never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp, *sources],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.vut_error_string.argtypes = [ctypes.c_int]
        lib.vut_error_string.restype = ctypes.c_char_p
        lib.vut_flood_phase_names.argtypes = []
        lib.vut_flood_phase_names.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptxas_report() -> str:
    """What `ptxas -v` says of each kernel (registers, shared memory,
    spills): each source compiled alone with the library's flags."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(CSRC.glob("*.cu")):
            proc = subprocess.run(
                [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / (src.stem + ".o")), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{proc.stderr}")
            report.append(f"== {src.name}\n{proc.stderr.strip()}")
    return "\n".join(report)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = library().vut_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


if __name__ == "__main__":
    # python -m video_unscreen_tpu_torch.ops.kernels.build: build the
    # library and print each kernel's registers and shared memory
    print(build())
    print(ptxas_report())
