"""Host ms a scene in base_detector.detect (RPN, RoIAlign, R-CNN, NMS), from the window's spans."""
from perfbench import readers


def read(obs):
    return readers.span_ms(obs, 'detect', 'eval')
