"""Steps completed over the whole window, one scene a step (train loop)."""
from perfbench import readers


def read(obs):
    return readers.rate(obs, 'train')
