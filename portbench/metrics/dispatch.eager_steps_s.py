"""dispatch.eager_steps_s: seconds of the program's eager train steps (in
the cells, the set-up's steps before a chunk captures its step, the first
with the lazy CUDA, cuDNN, cuBLAS and kernel-library initialisation), host
time to each step's return, in the run's process, from the program's TIMES
table; nothing where the program has no such entry."""

from portbench import spans


def read(r):
    return spans.timed_s('dispatch.eager_steps_s')
