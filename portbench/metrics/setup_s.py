"""Seconds from the process's start to the window's: imports, CUDA start,
the kernel libraries (built in the first run of a checkout, loaded after),
weights and images from the seed, and the warm-up of the cell's shapes."""


def read(obs):
    return obs["setup_s"]
