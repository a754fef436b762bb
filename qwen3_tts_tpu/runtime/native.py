"""ctypes bindings for libttsrt (native/ttsrt.cc) — the native runtime.

Same layering as the reference's llama_cpp_bindings.py (typed ctypes over a
C-ABI shim), covering:
- zero-copy safetensors access (mmap) for fast weight loading
- npy read/write
- WAV write + f32->i16 conversion
- a Unix-socket daemon loop with exact framing, dispatching to a Python
  handler (used by serve/daemon.py)

Every entry point has a pure-Python fallback so the framework runs without
the compiled library; ``available()`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Callable, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_NATIVE_DIR, "libttsrt.so")
    # make first, every time: a no-op when the library is up to date, and
    # a rebuild from the tracked sources when a stale copy came with the
    # tree; without a working toolchain the pure-Python paths serve
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.ttsrt_st_open.restype = ctypes.c_void_p
    lib.ttsrt_st_open.argtypes = [ctypes.c_char_p]
    lib.ttsrt_st_count.restype = ctypes.c_int
    lib.ttsrt_st_count.argtypes = [ctypes.c_void_p]
    lib.ttsrt_st_name.restype = ctypes.c_char_p
    lib.ttsrt_st_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ttsrt_st_info.restype = ctypes.c_int
    lib.ttsrt_st_info.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.ttsrt_st_data.restype = ctypes.c_void_p
    lib.ttsrt_st_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ttsrt_st_close.argtypes = [ctypes.c_void_p]

    lib.ttsrt_npy_read.restype = ctypes.c_void_p
    lib.ttsrt_npy_read.argtypes = [ctypes.c_char_p]
    lib.ttsrt_npy_ndim.restype = ctypes.c_int
    lib.ttsrt_npy_ndim.argtypes = [ctypes.c_void_p]
    lib.ttsrt_npy_dim.restype = ctypes.c_int64
    lib.ttsrt_npy_dim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ttsrt_npy_dtype.restype = ctypes.c_char_p
    lib.ttsrt_npy_dtype.argtypes = [ctypes.c_void_p]
    lib.ttsrt_npy_data.restype = ctypes.c_void_p
    lib.ttsrt_npy_data.argtypes = [ctypes.c_void_p]
    lib.ttsrt_npy_free.argtypes = [ctypes.c_void_p]
    lib.ttsrt_npy_write.restype = ctypes.c_int
    lib.ttsrt_npy_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_char_p]

    lib.ttsrt_wav_write.restype = ctypes.c_int
    lib.ttsrt_wav_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int]
    lib.ttsrt_f32_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]

    lib.ttsrt_serve_unix.restype = ctypes.c_int
    # int64_t caps: without argtypes ctypes would pass Python ints as
    # 32-bit c_int — a >=2 GiB resp_cap then raises ArgumentError
    lib.ttsrt_serve_unix.argtypes = [ctypes.c_char_p, _HANDLER_T,
                                     ctypes.c_int64, ctypes.c_int64]
    lib.ttsrt_serve_stop.restype = None
    if hasattr(lib, "ttsrt_serve_reset"):  # absent in pre-r3 builds
        lib.ttsrt_serve_reset.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# safetensors (zero-copy)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": None,  # bf16 special-cased
    "I64": np.int64, "I32": np.int32, "F64": np.float64, "U8": np.uint8,
}


def _bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    out = np.zeros(raw_u16.shape, np.uint32)
    out |= raw_u16.astype(np.uint32) << 16
    return out.view(np.float32)


class _PySafetensors:
    """Pure-Python mmap safetensors parser (fallback when libttsrt isn't
    built). Unlike safetensors.numpy it reads BF16 (upcast to float32) —
    real Qwen checkpoints store weights in bf16."""

    _DTYPES = {
        "F64": np.float64, "F32": np.float32, "F16": np.float16,
        "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
        "U8": np.uint8, "U16": np.uint16, "U32": np.uint32, "U64": np.uint64,
        "BOOL": np.bool_,
    }

    def __init__(self, path: str):
        import json
        self._mm = np.memmap(path, np.uint8, mode="r")
        hlen = int(np.frombuffer(self._mm[:8], np.uint64)[0])
        header = json.loads(bytes(self._mm[8:8 + hlen]).decode("utf-8"))
        header.pop("__metadata__", None)
        self._base = 8 + hlen
        self._meta = header

    def keys(self):
        return list(self._meta.keys())

    def tensor(self, name: str) -> np.ndarray:
        meta = self._meta[name]
        dt, shape = meta["dtype"], tuple(meta["shape"])
        beg, end = meta["data_offsets"]
        buf = self._mm[self._base + beg:self._base + end]
        if dt == "BF16":
            return _bf16_to_f32(
                np.frombuffer(buf, np.uint16).reshape(shape))
        npdt = self._DTYPES.get(dt)
        if npdt is None:
            raise ValueError(f"unsupported safetensors dtype {dt}")
        return np.frombuffer(buf, npdt).reshape(shape)


class SafetensorsFile:
    """mmap-backed zero-copy safetensors reader (native), with a
    pure-Python mmap fallback. Both paths read BF16 (upcast to f32)."""

    def __init__(self, path: str):
        self.path = path
        self._h = None
        self._fallback = None
        lib = _load()
        if lib is not None:
            self._h = lib.ttsrt_st_open(path.encode())
        if not self._h:
            self._fallback = _PySafetensors(path)

    def keys(self):
        if self._fallback is not None:
            return self._fallback.keys()
        lib = _LIB
        n = lib.ttsrt_st_count(self._h)
        return [lib.ttsrt_st_name(self._h, i).decode() for i in range(n)]

    def tensor(self, name: str) -> np.ndarray:
        """Returns a numpy view (zero-copy for the native path; bf16 is
        upcast to float32)."""
        if self._fallback is not None:
            return self._fallback.tensor(name)
        lib = _LIB
        dtype_buf = ctypes.create_string_buffer(8)
        shape = (ctypes.c_int64 * 8)()
        nbytes = ctypes.c_int64()
        ndim = lib.ttsrt_st_info(self._h, name.encode(), dtype_buf, shape,
                                 ctypes.byref(nbytes))
        if ndim < 0:
            raise KeyError(name)
        ptr = lib.ttsrt_st_data(self._h, name.encode())
        shp = tuple(shape[i] for i in range(ndim))
        dt = dtype_buf.value.decode()
        buf = (ctypes.c_char * nbytes.value).from_address(ptr)
        if dt == "BF16":
            return _bf16_to_f32(np.frombuffer(buf, np.uint16).reshape(shp))
        npdt = _ST_DTYPES.get(dt)
        if npdt is None:
            raise ValueError(f"unsupported dtype {dt}")
        return np.frombuffer(buf, npdt).reshape(shp)

    def close(self):
        if self._h and _LIB is not None:
            _LIB.ttsrt_st_close(self._h)
            self._h = None


def read_safetensors(path: str) -> dict:
    """Load every tensor of a .safetensors file as numpy arrays (native
    mmap reader when libttsrt is built, pure-Python parser otherwise;
    BF16 upcast to float32 on both paths — real Qwen checkpoints are
    bf16, which the safetensors numpy backend cannot read)."""
    f = SafetensorsFile(path)
    try:
        # explicit copy: tensor() returns views into the mmap, which close()
        # unmaps — np.asarray alone would NOT copy and would leave the dict
        # holding dangling pointers
        return {k: np.array(f.tensor(k), copy=True) for k in f.keys()}
    finally:
        f.close()


# ---------------------------------------------------------------------------
# npy / WAV helpers
# ---------------------------------------------------------------------------

def npy_read(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np.load(path)
    h = lib.ttsrt_npy_read(path.encode())
    if not h:
        raise IOError(f"npy read failed: {path}")
    try:
        ndim = lib.ttsrt_npy_ndim(h)
        shape = tuple(lib.ttsrt_npy_dim(h, i) for i in range(ndim))
        dt = lib.ttsrt_npy_dtype(h).decode()
        np_dt = np.dtype(dt)
        n = int(np.prod(shape)) if shape else 1
        buf = (ctypes.c_char * (n * np_dt.itemsize)).from_address(
            lib.ttsrt_npy_data(h))
        return np.frombuffer(buf, np_dt).reshape(shape).copy()
    finally:
        lib.ttsrt_npy_free(h)


def npy_write(path: str, arr: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str  # e.g. '<f4'
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    rc = lib.ttsrt_npy_write(path.encode(), arr.ctypes.data, shape,
                             arr.ndim, dt.encode())
    if rc != 0:
        raise IOError(f"npy write failed: {path}")


def wav_write(path: str, audio_int16: np.ndarray, sample_rate: int) -> None:
    lib = _load()
    if lib is None:
        from qwen3_tts_tpu.io.wav import write_wav
        write_wav(path, audio_int16, sample_rate)
        return
    a = np.ascontiguousarray(audio_int16, np.int16)
    rc = lib.ttsrt_wav_write(path.encode(), a.ctypes.data, len(a), sample_rate)
    if rc != 0:
        raise IOError(f"wav write failed: {path}")


def f32_to_i16(audio: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(audio, np.float32)
    if lib is None:
        return np.clip(a * 32767, -32768, 32767).astype(np.int16)
    out = np.empty(len(a), np.int16)
    lib.ttsrt_f32_to_i16(a.ctypes.data, out.ctypes.data, len(a))
    return out


# ---------------------------------------------------------------------------
# daemon serve loop
# ---------------------------------------------------------------------------

_HANDLER_T = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_int64, ctypes.c_int)

_TTSRT_HANDLED = -2  # handler wrote frames to the fd itself (ttsrt.cc)


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def serve_unix(socket_path: str, handler, max_req: int = 1 << 20,
               resp_cap: int = 1 << 26) -> int:
    """Run the native accept/framing loop. ``handler(request_bytes,
    send_frame)`` either returns response bytes (single framed response) or
    calls ``send_frame(payload)`` one or more times — each call writes
    ``[u32 len][payload]`` straight to the connection (chunked/streaming
    responses) — and returns None. Blocks until ``serve_stop()``. The
    stop flag is process-global and sticky: call ``serve_reset()`` before
    entering if a previous ``serve_stop()`` may have fired (the loop does
    NOT clear it itself, so a stop racing the entry is honored). Native
    library required (serve/daemon.py falls back to a pure-Python loop
    otherwise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libttsrt not available")
    import struct

    @_HANDLER_T
    def c_handler(req_ptr, req_len, resp_ptr, cap, fd):
        try:
            req = ctypes.string_at(req_ptr, req_len)

            def send_frame(payload: bytes) -> None:
                _write_all(fd, struct.pack("<I", len(payload)) + payload)

            resp = handler(req, send_frame)
            if resp is None:
                return _TTSRT_HANDLED
            if len(resp) > cap:
                return -1
            ctypes.memmove(resp_ptr, resp, len(resp))
            return len(resp)
        except Exception:
            return -1

    return lib.ttsrt_serve_unix(socket_path.encode(), c_handler,
                                max_req, resp_cap)


def serve_stop() -> None:
    lib = _load()
    if lib is not None:
        lib.ttsrt_serve_stop()


def serve_reset() -> None:
    """Re-arm the (process-global) native stop flag before entering
    serve_unix. Separate from the loop entry so a stop() racing it is
    sticky rather than erased (see ttsrt.cc)."""
    lib = _load()
    if lib is not None and hasattr(lib, "ttsrt_serve_reset"):
        lib.ttsrt_serve_reset()
