"""Time-frequency front-ends (port of pyfasst_tpu/tf; the STFT so far)."""

from pyfasst_tpu_torch.tf.stft import STFT, istft, stft  # noqa: F401
