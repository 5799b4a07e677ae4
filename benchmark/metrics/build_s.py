"""Host clock around the index build, ending in a synchronize of every card."""


def read(run):
    return run.build_s
