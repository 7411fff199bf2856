"""Time-frequency front-ends (port of pyfasst_tpu/tf): the STFT, and the
ERB/Mel spectral bases."""

from pyfasst_tpu_torch.tf.filterbank import spectral_basis  # noqa: F401
from pyfasst_tpu_torch.tf.stft import STFT, istft, stft  # noqa: F401
