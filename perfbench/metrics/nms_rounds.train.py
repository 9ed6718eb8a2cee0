"""NMS fixpoint rounds a step over the window (core.nms.greedy_fixpoint.rounds)."""
from perfbench import readers


def read(obs):
    return readers.per_call(obs, 'nms_rounds', 'train')
