"""R007 fixture: host debug I/O inside step functions."""
import logging
import sys


def make_train_step():
    def step(params, state, batch):
        print("step!", params)           # R007: print in a step
        sys.stdout.write("loss\n")       # R007
        logging.info("state %s", state)  # R007
        return params, state, batch

    return step


def report():
    print("outside a step is fine")
