"""Host ms a step in dist.apply_update (clip, AdamW), from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'update', 'train')
