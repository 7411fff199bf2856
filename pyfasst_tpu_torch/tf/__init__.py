"""Time-frequency front-ends (port of pyfasst_tpu/tf): the STFT, the
ERBlet and min-Q transforms, the ERB/Mel filterbanks and their ERB
front-end, WPE dereverberation, and the block-streaming STFT pair
(STFT.stream_blocks, StreamingSynthesis)."""

from pyfasst_tpu_torch.tf.dereverb import wpe_dereverb  # noqa: F401
from pyfasst_tpu_torch.tf.erblet import (  # noqa: F401
    ERBLetTransform, MultiRateERBLet,
)
from pyfasst_tpu_torch.tf.filterbank import (  # noqa: F401
    ERBTransform, MelBank, erb_filterbank, mel_filterbank, spectral_basis,
)
from pyfasst_tpu_torch.tf.minqt import MinQTransfo  # noqa: F401
from pyfasst_tpu_torch.tf.stft import (  # noqa: F401
    STFT, StreamingSynthesis, istft, stft,
)
