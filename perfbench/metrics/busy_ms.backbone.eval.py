"""Device ms a scene of the work MV2D.extract_feats enqueued (profiled slice)."""
from perfbench import readers


def read(obs):
    return readers.busy_ms(obs, 'backbone', 'eval')
