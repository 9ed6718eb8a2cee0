"""Summed least time (perfbench.roofline) over summed device time of the hand-kernel calls in the profiled slice."""
from perfbench import readers


def read(obs):
    return readers.traced(obs, 'roofline_pct', 'train')
