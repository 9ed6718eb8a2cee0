"""Scenes completed over the whole window (eval loop)."""
from perfbench import readers


def read(obs):
    return readers.rate(obs, 'eval')
