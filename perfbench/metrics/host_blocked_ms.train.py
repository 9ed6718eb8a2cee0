"""Host ms a step blocked in device syncs and device-to-host copies (one step under the sync debug mode)."""
from perfbench import readers


def read(obs):
    return readers.traced(obs, 'blocked_ms', 'train')
