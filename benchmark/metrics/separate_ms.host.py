"""separate_ms.host: ms of separate_spat_comps (the Wiener images, the
inverse STFT, the copy to the host and the J WAV writes); the mean over
the traced window's clips."""


def read(r):
    s = r.spans["separate_s"]
    return 1e3 * sum(s) / len(s) if s else None
