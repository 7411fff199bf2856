"""Host-side audio I/O.

Port of pyfasst_tpu/audio.py through scipy.io.wavfile only (the native
codec waits for ROADMAP item 8). ``data`` is a float array of shape
(nsamples, channels) in [-1, 1]; PCM is scaled as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
from scipy.io import wavfile as _wavfile

_PCM_SCALE = {np.dtype(np.int16): 2.0 ** 15,
              np.dtype(np.int32): 2.0 ** 31,
              np.dtype(np.uint8): 2.0 ** 7}


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
        sr, raw = _wavfile.read(self.filename)
        self.samplerate = int(sr)
        raw = np.asarray(raw)
        if raw.dtype in _PCM_SCALE:
            data = raw.astype(np.float64)
            if raw.dtype == np.dtype(np.uint8):  # 8-bit WAV is unsigned
                data = data - 128.0
            data = data / _PCM_SCALE[raw.dtype]
        else:  # float32/float64 WAV
            data = raw.astype(np.float64)
        self.data = self._as_2d_float(data)

    def _write(self, filename: Optional[str] = None, dtype=np.int16) -> str:
        """Write ``data`` to a WAV file (PCM16 by default)."""
        path = filename or self.filename
        if path is None:
            raise ValueError("no filename to write to")
        if self.data is None:
            raise ValueError("no data to write")
        data = np.clip(self.data, -1.0, 1.0)
        if np.dtype(dtype) == np.dtype(np.int16):
            out = np.round(data * (2.0 ** 15 - 1)).astype(np.int16)
        else:
            out = data.astype(dtype)
        _wavfile.write(path, self.samplerate, out)
        return path

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

