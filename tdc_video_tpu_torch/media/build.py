"""Build the native FFmpeg decoder (media/native/decoder.cc, g++ ->
libtdc_media-<hash>.so) at first use.

The library goes to `tdc_video_tpu_torch/_build/`, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused.  Needs g++ and FFmpeg's development libraries (libavformat,
libavcodec, libswscale, libswresample, libavutil); `ffmpeg_libraries`
says whether pkg-config finds them.  Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "native" / "decoder.cc"
BUILD_DIR = PKG / "_build"
FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread"]
MODULES = ("libavformat", "libavcodec", "libswscale", "libswresample", "libavutil")
LIBS = ["-lavformat", "-lavcodec", "-lswscale", "-lswresample", "-lavutil"]


def ffmpeg_libraries() -> Tuple[bool, str]:
    """(found, pkg-config's output): whether pkg-config lists every FFmpeg
    library the decoder links, with their versions or its error message."""
    try:
        r = subprocess.run(["pkg-config", "--modversion", *MODULES], capture_output=True,
                           text=True, timeout=60)
    except FileNotFoundError as e:
        return False, f"pkg-config not found: {e}"
    return r.returncode == 0, (r.stdout + r.stderr).strip()


def lib_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libtdc_media-{h.hexdigest()[:12]}.so"


def build() -> str:
    """Compile if missing; returns the .so path."""
    lib = lib_path()
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name} (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)
    return str(lib)


if __name__ == "__main__":
    print(build())
