"""xrt.host: audio-seconds of every clip taken from its WAV file to WAV
files through the host API in the window, over the window's wall time."""
from harness.readers import xrt as read  # noqa: F401
