"""Host ms a scene blocked in device syncs and device-to-host copies (one call under the sync debug mode)."""
from perfbench import readers


def read(obs):
    return readers.traced(obs, 'blocked_ms', 'eval')
