"""Seconds from the process's start to the window's: imports, kernel
builds (the first run in a checkout), documents generated from the seed,
one warm sync a document that builds its session, one sync a client of the
mix's own traffic."""


def read(ctx):
    return ctx["setup_s"]
