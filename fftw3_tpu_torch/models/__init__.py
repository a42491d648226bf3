"""Spectral application models on the port's plans — the port of
``fftw3_tpu/models/``.  Ported so far: the pseudo-spectral 2-D
Navier-Stokes step (``navier_stokes.py``) and the Poisson solvers
(``poisson.py``)."""
from .navier_stokes import (distributed_step_fn,  # noqa: F401
                            step_fn as navier_stokes_step,
                            taylor_green_vorticity)
from .poisson import (laplacian_periodic, solve_dirichlet,  # noqa: F401
                      solve_neumann, solve_neumann_fn, solve_periodic)
