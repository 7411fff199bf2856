"""init_ms.host: ms of the host API's constructor
(models/variants.py::MultiChanNMFInst_FASST: the WAV read, the STFT and
the initial draw), synchronised before and after; the mean over the
traced window's clips."""


def read(r):
    s = r.spans["init_s"]
    return 1e3 * sum(s) / len(s) if s else None
