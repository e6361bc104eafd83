"""TCI2 iterations a solve: the length of the errors series that
crossinterpolate2 returned, over the window's solves."""


def read(run):
    its = [len(s.errors) for s in run.solves if s.errors]
    return sum(its) / len(its) if its else None
