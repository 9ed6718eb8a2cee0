"""Share of the profiled slice with no device work: 1 - the union of its kernels' intervals over its wall time."""
from perfbench import readers


def read(obs):
    return readers.idle_pct(obs, 'train')
