"""setup_s: process start to the window's start (host clock), seconds."""


def read(run):
    return run.setup_s
