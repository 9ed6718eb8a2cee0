"""Host ms a scene in roi_head.position_encoding, from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'pe', 'eval')
