"""The 95th percentile of scene latency (send to detections on the host), over every scene of the window."""
from perfbench import readers


def read(obs):
    return readers.p95_ms(obs, 'eval')
