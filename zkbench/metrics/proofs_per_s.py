"""Groth16 proofs answered in the timed window over its seconds (host
clock: the window runs whole steps, and its length is the time from its
start to the end of its last step)."""


def read(run):
    if not run.window_s:
        return None
    return run.answered / run.window_s
