"""Seconds from the harness's start to the window: importing torch and
the port, loading (or, in a fresh checkout, building) its kernel library,
planning, making the inputs and warming up the cell's plan."""


def read(run, params):
    return run.setup_s
