"""setup_s: from the start of the process to the opening of the window:
imports, the card's start, kernel builds (the first run in a checkout),
the inputs made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
