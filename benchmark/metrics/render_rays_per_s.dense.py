"""Rays of the orbit's completed frames over the window's wall time, in a
cell whose frames the card's chunked kernels pace, rays/s."""

from benchmark import readers


def read(run):
    return readers.rays_per_s(run)
