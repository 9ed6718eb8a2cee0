"""Device ms a step of the work enqueued between dp_objective and apply_update: the backward (profiled slice)."""
from perfbench import readers


def read(obs):
    return readers.busy_ms(obs, 'backward', 'train')
