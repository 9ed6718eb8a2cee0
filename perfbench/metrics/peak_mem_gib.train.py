"""torch.cuda.max_memory_allocated() at the window's end, GiB."""
from perfbench import readers


def read(obs):
    return readers.peak_gib(obs, 'train')
