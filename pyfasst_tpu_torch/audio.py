"""Host-side audio I/O.

Port of pyfasst_tpu/audio.py. The WAV codec is NumPy, in this module: it
reads PCM u8/16/24/32 and IEEE float32/64, with extra chunks and
WAVE_FORMAT_EXTENSIBLE headers, writes PCM16/24 and float32, and reads a
block (offset + frame count) without decoding the rest. It decodes and
encodes exactly as the JAX package's native codec (pyfasst_tpu/native/
wavio.cpp) does, with nothing to build. ``data`` is a float array of
shape (nsamples, channels) in [-1, 1].
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np

_PCM_DIV = {8: 128.0, 16: 32768.0, 24: 8388608.0, 32: 2147483648.0}
_WRITE_BITS = {np.dtype(np.int16): 16, np.dtype(np.float32): 32}


def _parse_header(fh, path) -> dict:
    """The fmt fields and the data chunk's offset and size of an open WAV
    file. Sizes in the file are clamped to what it holds and block_align
    is derived from channels and bits, never trusted; malformed headers
    raise ValueError."""
    def bad(msg):
        return ValueError(f"{path}: {msg}")

    hdr = fh.read(12)
    if len(hdr) < 12:
        raise bad("not a WAV file (short header)")
    if hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
        raise bad("not a WAV file (missing RIFF/WAVE magic)")
    fh.seek(0, os.SEEK_END)
    file_end = fh.tell()
    fh.seek(12)
    info, data_offset, data_bytes = None, None, 0
    while info is None or data_offset is None:
        ch = fh.read(8)
        if len(ch) < 8:
            raise bad("truncated WAV: missing fmt or data chunk")
        size = int.from_bytes(ch[4:8], "little")
        if ch[:4] == b"fmt ":
            if size < 16 or size > 1 << 20:
                raise bad("malformed fmt chunk")
            buf = fh.read(size)
            if len(buf) < size:
                raise bad("malformed fmt chunk")
            fmt = int.from_bytes(buf[0:2], "little")
            info = {"format": fmt,
                    "channels": int.from_bytes(buf[2:4], "little"),
                    "samplerate": int.from_bytes(buf[4:8], "little"),
                    "bits": int.from_bytes(buf[14:16], "little")}
            if fmt == 0xFFFE:                      # WAVE_FORMAT_EXTENSIBLE
                if size < 40:
                    raise bad("malformed extensible fmt chunk")
                info["format"] = int.from_bytes(buf[24:26], "little")
        elif ch[:4] == b"data":
            data_offset = fh.tell()
            data_bytes = size
            # a data chunk that runs past the end (streamed writers) keeps
            # what the file holds
            fh.seek(min(data_offset + size + (size & 1), file_end))
        else:                     # a chunk past the end: the next read fails
            fh.seek(fh.tell() + size + (size & 1))
    if info["channels"] == 0 or info["samplerate"] == 0:
        raise bad("malformed fmt chunk (zero channels or samplerate)")
    info["data_offset"] = data_offset
    info["data_bytes"] = max(0, min(data_bytes, file_end - data_offset))
    info["block_align"] = info["channels"] * ((info["bits"] + 7) // 8)
    if info["block_align"] == 0:
        raise bad("malformed fmt chunk (zero block align)")
    if info["format"] == 1:
        if info["bits"] not in _PCM_DIV:
            raise bad("unsupported PCM bit depth")
    elif info["format"] == 3:
        if info["bits"] not in (32, 64):
            raise bad("unsupported float bit depth")
    else:
        raise bad("unsupported WAV format code (only PCM and IEEE float)")
    return info


def _decode(raw: bytes, info: dict) -> np.ndarray:
    """Raw sample bytes -> float64 (frames, channels), normalized."""
    bits, ch = info["bits"], info["channels"]
    if info["format"] == 3:
        data = np.frombuffer(raw, "<f4" if bits == 32 else "<f8")
        data = data.astype(np.float64)
    elif bits == 8:                              # PCM u8 is unsigned
        data = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) \
            / 128.0
    elif bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = np.where(v & 0x800000, v - (1 << 24), v)
        data = v / _PCM_DIV[24]
    else:
        data = np.frombuffer(raw, "<i2" if bits == 16 else "<i4") \
            / _PCM_DIV[bits]
    return data.reshape(-1, ch)


def wav_info(path) -> dict:
    """Header of a WAV file: samplerate, channels, frames, bits and format
    ("pcm" or "float"). OSError if it cannot be opened, ValueError if it
    is not a WAV file this codec reads."""
    path = os.fspath(path)
    with open(path, "rb") as fh:
        info = _parse_header(fh, path)
    return {"samplerate": info["samplerate"], "channels": info["channels"],
            "frames": info["data_bytes"] // info["block_align"],
            "bits": info["bits"],
            "format": "float" if info["format"] == 3 else "pcm"}


def wav_read(path, offset: int = 0, frames: int = -1
             ) -> Tuple[np.ndarray, int]:
    """(float64 (frames, channels) in [-1, 1], samplerate) of a WAV file.

    offset/frames select a block: only its bytes are read. Reads past the
    end are clamped (an offset past the end gives zero frames)."""
    path = os.fspath(path)
    if offset < 0:
        raise ValueError("offset must be >= 0")
    with open(path, "rb") as fh:
        info = _parse_header(fh, path)
        align = info["block_align"]
        total = info["data_bytes"] // align
        start = min(offset, total)
        n = total - start
        if 0 <= frames < n:
            n = frames
        fh.seek(info["data_offset"] + start * align)
        raw = fh.read(n * align)
    if len(raw) < n * align:
        raise ValueError(f"{path}: truncated sample data")
    return _decode(raw, info), info["samplerate"]


def wav_write(path, data: np.ndarray, samplerate: int, bits: int = 16
              ) -> str:
    """Write float data (frames, channels) in [-1, 1] as PCM16, PCM24 or
    (bits=32) IEEE float32; PCM is clipped and rounded half to even."""
    if bits not in (16, 24, 32):
        raise ValueError("bits must be 16, 24, or 32 (float32)")
    data = np.asarray(data, np.float64)
    if data.ndim != 2:
        raise ValueError(f"data must be 2-D (frames, channels), got "
                         f"{data.shape}")
    frames, channels = data.shape
    nbytes = bits // 8
    if bits == 32:
        payload = data.astype("<f4").tobytes()
    else:
        q = np.rint(np.clip(data, -1.0, 1.0)
                    * (32767.0 if bits == 16 else 8388607.0)).astype("<i4")
        if bits == 16:
            payload = q.astype("<i2").tobytes()
        else:
            payload = q.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    header = b"".join([
        b"RIFF", (36 + len(payload)).to_bytes(4, "little"), b"WAVE",
        b"fmt ", (16).to_bytes(4, "little"),
        (3 if bits == 32 else 1).to_bytes(2, "little"),
        channels.to_bytes(2, "little"), int(samplerate).to_bytes(4, "little"),
        (int(samplerate) * channels * nbytes).to_bytes(4, "little"),
        (channels * nbytes).to_bytes(2, "little"), bits.to_bytes(2, "little"),
        b"data", len(payload).to_bytes(4, "little")])
    path = os.fspath(path)
    with open(path, "wb") as fh:
        fh.write(header + payload)
    return path


class AudioObject:
    """A loaded (or to-be-written) audio signal: ``data``, ``samplerate``,
    ``channels``. Construct from a filename (reads immediately) or from raw
    data."""

    def __init__(self,
                 filename: Optional[Union[str, os.PathLike]] = None,
                 data: Optional[np.ndarray] = None,
                 samplerate: int = 44100):
        self.filename = os.fspath(filename) if filename is not None else None
        self.samplerate = int(samplerate)
        self.data: Optional[np.ndarray] = None
        if data is not None:
            self.data = self._as_2d_float(np.asarray(data))
        elif filename is not None:
            self._read()

    def _read(self) -> None:
        """Read the WAV file into float64 (nsamples, channels) in [-1, 1]."""
        data, sr = wav_read(self.filename)
        self.samplerate = int(sr)
        self.data = self._as_2d_float(data)

    def _write(self, filename: Optional[str] = None, dtype=np.int16) -> str:
        """Write ``data`` to a WAV file: PCM16 (dtype int16, the default) or
        IEEE float32 (dtype float32)."""
        path = filename or self.filename
        if path is None:
            raise ValueError("no filename to write to")
        if self.data is None:
            raise ValueError("no data to write")
        if np.dtype(dtype) not in _WRITE_BITS:
            raise ValueError(f"cannot write WAV samples of dtype {dtype}; "
                             "use int16 or float32")
        return wav_write(path, np.clip(self.data, -1.0, 1.0),
                         self.samplerate, bits=_WRITE_BITS[np.dtype(dtype)])

    @property
    def channels(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    @property
    def nsamples(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def duration(self) -> float:
        return self.nsamples / float(self.samplerate)

    @staticmethod
    def _as_2d_float(data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError(f"audio data must be 1-D or 2-D, got {data.shape}")
        if data.shape[0] < data.shape[1]:
            data = data.T
        return data


def wavread(filename) -> Tuple[np.ndarray, int]:
    """(data (nsamples, channels), samplerate) of a WAV file."""
    obj = AudioObject(filename)
    return obj.data, obj.samplerate


def wavwrite(data: np.ndarray, samplerate: int, filename: str) -> str:
    """Write float data in [-1, 1] as a PCM16 WAV file."""
    return AudioObject(data=data, samplerate=samplerate)._write(filename)


def wavread_block(filename, offset: int, frames: int
                  ) -> Tuple[np.ndarray, int]:
    """Read `frames` samples starting at `offset` without decoding the rest
    of the file (the streaming loader's page)."""
    return wav_read(filename, offset=int(offset), frames=int(frames))
