"""models.init_s: seconds of the program's model set-up (models/factory.py
create_model: the nets built and initialised, moved to the device, the
optimizers and pools) in the run's process, from the program's TIMES table;
nothing where the program has no such entry."""

from portbench import spans


def read(r):
    return spans.timed_s('models.init_s')
