"""Host ms a scene in MV2D.decode, from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'decode', 'eval')
