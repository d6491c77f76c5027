"""JPEG decode through libjpeg, bound with ctypes.

Counterpart of the decode half of
``behavior_driven_video_synthesis_tpu/data/native.py`` (``decode_available``,
``decode_jpeg``, ``jpeg_dims``, ``jpeg_orientation``, ``pick_scale_denom``,
``decode_jpeg_batch``).  The library is the repo's
``native/bdvs_native.cpp`` (libjpeg with DCT-domain scaling), compiled on
first use with ``g++ ... -ljpeg`` into
``build/torch_kernels/bdvs_native-<hash>/`` at the root of the checkout (or
under ``$BDVS_TORCH_BUILD_DIR``), beside the CUDA kernels; the hash covers
the source and the flags.  Only its decode entry points are bound.

Where the library cannot be built (no compiler, no libjpeg headers),
:func:`decode_available` is False and callers decode with cv2
(``data/base.py:_load_image_rgb``); :func:`build_error` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bdvs_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpthread", "-ljpeg")

_LIB: Optional[ctypes.CDLL] = None
_ATTEMPTED = False
_ERROR: Optional[str] = None


def library_path() -> Path:
    from ..ops.cuda.build import _build_root

    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return (_build_root() / f"bdvs_native-{h.hexdigest()[:16]}"
            / "libbdvs_native.so")


def _build(lib_path: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True,
                          check=False, timeout=300)
    (lib_path.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: two processes may build at once


def _load() -> Optional[ctypes.CDLL]:
    """The library, built once on first use; None if it cannot be."""
    global _LIB, _ATTEMPTED, _ERROR
    if _LIB is not None or _ATTEMPTED:
        return _LIB
    _ATTEMPTED = True
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _ERROR = str(e).strip() or repr(e)
        return None
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.decode_jpeg.argtypes = [u8, ctypes.c_longlong, ctypes.c_int, u8,
                                ctypes.c_longlong, i32, i32]
    lib.decode_jpeg.restype = ctypes.c_int
    lib.decode_jpeg_batch.argtypes = [u8, i64, ctypes.c_int, ctypes.c_int, u8,
                                      ctypes.c_longlong, i32, i32,
                                      ctypes.c_int]
    lib.decode_jpeg_batch.restype = None
    _LIB = lib
    return lib


def decode_available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, the compiler's messages included
    (None if it is, or was not tried)."""
    return _ERROR


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_jpeg(data: bytes, scale_denom: int = 1) -> np.ndarray:
    """One JPEG stream -> (H, W, 3) uint8 RGB, its dims ceil(dim /
    scale_denom) for scale_denom in {1, 2, 4, 8} (libjpeg's DCT-domain
    downscale).  ValueError if the stream does not decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the JPEG decode library is not available: "
                           f"{_ERROR}")
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom {scale_denom} is not 1, 2, 4 or 8")
    buf = np.frombuffer(data, np.uint8)
    h, w = jpeg_dims(data)
    oh, ow = -(-h // scale_denom), -(-w // scale_denom)
    out = np.empty((oh, ow, 3), np.uint8)
    rh, rw = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.decode_jpeg(_ptr(buf, ctypes.c_uint8), len(data), scale_denom,
                         _ptr(out, ctypes.c_uint8), out.nbytes,
                         ctypes.byref(rh), ctypes.byref(rw))
    if rc != 0:
        raise ValueError(f"native jpeg decode failed (rc={rc})")
    if (rh.value, rw.value) != (oh, ow):
        raise ValueError(f"native jpeg decode wrote ({rh.value}, {rw.value}),"
                         f" the header gave ({oh}, {ow})")
    return out


def jpeg_dims(data: bytes):
    """(height, width) from the SOFn marker: a header scan, no pixels."""
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:          # a fill byte: the next byte is a marker
            i += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise ValueError("no SOF marker found in jpeg stream")


def jpeg_orientation(data: bytes):
    """The EXIF Orientation tag (0x0112) of the APP1 segment: None without
    an EXIF segment, 0 for one that does not parse (every read is clamped
    to the segment), else the tag's value.  cv2.imread applies the
    orientation and the library does not, so only (None, 1) may take the
    library."""
    i, n = 2, len(data)
    while i + 4 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:
            i += 1
            continue
        if marker == 0xDA:          # start of scan: no APP1 before pixels
            return None
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xE1 and data[i + 4:i + 10] == b"Exif\x00\x00":
            tiff, seg_end = i + 10, i + 2 + seg_len
            if seg_end > n:
                return 0
            try:
                endian = {b"II": "little", b"MM": "big"}.get(
                    bytes(data[tiff:tiff + 2]))
                if endian is None or tiff + 8 > seg_end:
                    return 0
                ifd = tiff + int.from_bytes(data[tiff + 4:tiff + 8], endian)
                if ifd < tiff or ifd + 2 > seg_end:
                    return 0
                n_entries = int.from_bytes(data[ifd:ifd + 2], endian)
                if ifd + 2 + 12 * n_entries > seg_end:
                    return 0
                for k in range(n_entries):
                    e = ifd + 2 + 12 * k
                    if int.from_bytes(data[e:e + 2], endian) == 0x0112:
                        return int.from_bytes(data[e + 8:e + 10], endian)
            except (IndexError, ValueError):
                return 0
            return None
        i += 2 + seg_len
    return None


def pick_scale_denom(h: int, w: int, min_dim: int) -> int:
    """The largest denominator in {1, 2, 4, 8} that keeps both output dims
    >= min_dim, so a later resize to min_dim stays a downscale."""
    denom = 1
    for d in (2, 4, 8):
        if -(-h // d) >= min_dim and -(-w // d) >= min_dim:
            denom = d
    return denom


def decode_jpeg_batch(streams, scale_denom: int = 1,
                      n_threads: int = 8) -> List[np.ndarray]:
    """JPEG streams -> (H, W, 3) uint8 RGB images, decoded by n_threads
    threads in C++ without the GIL."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the JPEG decode library is not available: "
                           f"{_ERROR}")
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom {scale_denom} is not 1, 2, 4 or 8")
    n = len(streams)
    if n == 0:
        return []
    shapes = [(-(-h // scale_denom), -(-w // scale_denom))
              for h, w in map(jpeg_dims, streams)]
    stride = max(h * w * 3 for h, w in shapes)
    data = np.frombuffer(b"".join(streams), np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    outs = np.empty((n, stride), np.uint8)
    dims = np.zeros((n, 2), np.int32)
    rcs = np.zeros(n, np.int32)
    lib.decode_jpeg_batch(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), n,
        scale_denom, _ptr(outs, ctypes.c_uint8), stride,
        _ptr(dims, ctypes.c_int32), _ptr(rcs, ctypes.c_int32), n_threads)
    bad = np.nonzero(rcs)[0]
    if len(bad):
        raise ValueError(f"native jpeg batch decode failed for {len(bad)} "
                         f"stream(s), first rc={rcs[bad[0]]} at {bad[0]}")
    wrong = [i for i in range(n) if tuple(dims[i]) != shapes[i]]
    if wrong:
        raise ValueError(f"native jpeg batch decode wrote {tuple(dims[wrong[0]])}"
                         f" at {wrong[0]}, the header gave {shapes[wrong[0]]}")
    return [outs[i, :h * w * 3].reshape(h, w, 3)
            for i, (h, w) in enumerate(shapes)]
