"""setup_s: process start until the first timed feed."""


def read(run):
    return run.setup_s
