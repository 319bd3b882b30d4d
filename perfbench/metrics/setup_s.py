"""Seconds from the process's start to the first timed step: imports,
the card's start, the inputs, the models' build, any steady solve and the
warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
