"""R004 fixture: TrainerState accessed by positional index."""


def momentum_of(state):
    return state[2]                      # R004: index, not field name


def opt_of(tstate):
    return tstate[0]                     # R004
