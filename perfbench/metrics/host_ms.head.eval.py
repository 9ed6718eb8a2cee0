"""Host ms a scene in MV2D.roi_head_forward (3D head), from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'head', 'eval')
