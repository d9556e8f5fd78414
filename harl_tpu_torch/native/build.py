"""Build and load the native vec-MuJoCo engine through ctypes (counterpart
of ``harl_tpu/native/build.py``).

``vec_mujoco.cc`` is compiled with ``g++`` against the mujoco wheel's
headers and ``libmujoco.so`` on first use, into
``harl_tpu_torch/_build/libvecmj-<hash>.so``: the hash of the source, the
flags and the wheel's library names the file, so an edited source or
another mujoco is rebuilt and an unchanged one is loaded as it is. The
library is written under a temporary name and renamed into place, so
processes that build at once never load a partial file. Nothing is built
when a module is imported. A missing mujoco wheel or a failed compile
raises ``ImportError`` (with the compiler's stderr), which the env routing
reads as "use the Python host env".
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

SRC = pathlib.Path(__file__).resolve().parent / "vec_mujoco.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _mujoco_paths():
    """(include dir, libmujoco.so) of the installed mujoco wheel."""
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("the native vec-MuJoCo engine needs the mujoco wheel") from e
    pkg = pathlib.Path(mujoco.__file__).resolve().parent
    include = pkg / "include"
    sos = sorted(pkg.glob("libmujoco.so*"))
    if not include.is_dir() or not sos:
        raise ImportError(f"mujoco wheel at {pkg} lacks headers or libmujoco")
    return include, sos[-1]


def library_path(libmujoco: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()
                            + str(libmujoco).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvecmj-{digest}.so"


def build() -> pathlib.Path:
    """Compile ``vec_mujoco.cc`` unless the library for this source exists."""
    include, libmujoco = _mujoco_paths()
    out = library_path(libmujoco)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, f"-I{include}", str(SRC), str(libmujoco),
           f"-Wl,-rpath,{libmujoco.parent}", "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:             # no g++ on this host
        os.unlink(tmp)
        raise ImportError(f"native vec_mujoco build failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise ImportError(f"native vec_mujoco build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and return the library with its C signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, dp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    signatures = {
        "vmj_create": (vp, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]),
        "vmj_nq": (ctypes.c_int, [vp]),
        "vmj_nv": (ctypes.c_int, [vp]),
        "vmj_nu": (ctypes.c_int, [vp]),
        "vmj_timestep": (ctypes.c_double, [vp]),
        "vmj_qpos0": (None, [vp, dp]),
        "vmj_set_state": (None, [vp, ctypes.c_int, dp, dp]),
        "vmj_get_state": (None, [vp, dp, dp]),
        "vmj_step": (None, [vp, dp, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]),
        "vmj_destroy": (None, [vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib
