"""Plain WAV files: IEEE float32 written, PCM16 and float32 read."""
from __future__ import annotations

import struct

import numpy as np


def write_float32(path, data: np.ndarray, fs: int) -> None:
    """(T, I) samples as a WAVE_FORMAT_IEEE_FLOAT file."""
    data = np.ascontiguousarray(data, dtype="<f4")
    T, I = data.shape
    payload = data.tobytes()
    header = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
              + b"fmt " + struct.pack("<IHHIIHH", 16, 3, I, fs, fs * I * 4,
                                      I * 4, 32)
              + b"data" + struct.pack("<I", len(payload)))
    with open(path, "wb") as fh:
        fh.write(header + payload)


def read(path):
    """(samples (T, I): int16 words for PCM16, float32 for IEEE float;
    sample rate)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a WAV file")
    pos, fmt = 12, None
    while pos + 8 <= len(raw):
        tag, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif tag == b"data":
            if fmt is None:
                raise ValueError(f"{path}: data before fmt")
            code, ch, fs, _, _, bits = fmt
            if (code, bits) == (1, 16):
                return np.frombuffer(body, "<i2").reshape(-1, ch), fs
            if (code, bits) == (3, 32):
                return np.frombuffer(body, "<f4").reshape(-1, ch), fs
            raise ValueError(f"{path}: format {code} at {bits} bits")
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")
