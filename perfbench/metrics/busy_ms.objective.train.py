"""Device ms a step of the work dist.dp_objective enqueued (profiled slice)."""
from perfbench import readers


def read(obs):
    return readers.busy_ms(obs, 'objective', 'train')
