"""xrt.batch: audio-seconds of every pipeline completed in the window over
the window's wall time (host clock; the window closes at the first
pipeline end past --seconds)."""
from harness.readers import xrt as read  # noqa: F401
