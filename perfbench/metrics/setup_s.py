"""Seconds from process start to the first timed call: imports, the kernel library, weights and scenes on the card, warm-up (training: the first steps)."""
def read(obs):
    return obs['setup_s']
