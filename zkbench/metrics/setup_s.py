"""Seconds from the start of the process to the first timed request:
imports, the inputs, the program's set-up (circuit, keys, upload) and one
warm step (host clock)."""


def read(run):
    return run.setup_s
