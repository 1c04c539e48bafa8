"""Rays of the fit's completed train steps over the window's wall time (ends
in a synchronise), rays/s."""

from benchmark import readers


def read(run):
    return readers.rays_per_s(run)
