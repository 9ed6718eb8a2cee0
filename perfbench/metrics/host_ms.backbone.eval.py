"""Host ms a scene in MV2D.extract_feats (backbone, FPN, neck), from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'backbone', 'eval')
