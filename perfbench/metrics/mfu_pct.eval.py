"""Model FLOPs a scene (perfbench.flops) times the window's rate, over 989 TFLOP/s."""
from perfbench import readers


def read(obs):
    return readers.mfu_pct(obs, 'eval')
