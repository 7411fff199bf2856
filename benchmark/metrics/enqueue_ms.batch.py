"""enqueue_ms.batch: host ms an iteration from the call of run_gem to its
return, before the device finishes (the eager loop's enqueue); the mean
over the traced window's pipelines."""


def read(r):
    s = r.spans["enqueue_s"]
    return 1e3 * sum(s) / len(s) / r.niter if s else None
