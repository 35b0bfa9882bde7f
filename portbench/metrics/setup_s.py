"""Process start to the first timed operation: imports, inputs, the
program's set-up, kernel builds or cache loads, warm-up."""


def read(run):
    return run.setup_s
