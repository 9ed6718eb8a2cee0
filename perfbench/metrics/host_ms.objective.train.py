"""Host ms a step in dist.dp_objective (forward, losses, matching), from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'objective', 'train')
