"""Device ms a scene of the work MV2D.roi_head_forward enqueued (profiled slice)."""
from perfbench import readers


def read(obs):
    return readers.busy_ms(obs, 'head', 'eval')
