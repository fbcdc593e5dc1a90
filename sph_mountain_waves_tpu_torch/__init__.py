"""sph_mountain_waves_tpu_torch — the PyTorch/CUDA port of the SPH framework.

A second package beside ``sph_mountain_waves_tpu`` (the JAX reference, which
it never imports). It keeps the reference's module layout and names, its
bucket-slot state layout and its configs, so every module's counterpart is
found under the same path and states compare slot for slot. Plain tensor
code is PyTorch; the pair sweeps that the reference wrote as Pallas TPU
kernels are CUDA C++ kernels for Hopper (``csrc/``), built with nvcc on first
use, each with a plain PyTorch twin that CPU tensors take. Entry points
(``ParticleSystem.freeze``, each scheme's ``run``) run on the card unless
the caller asks for the CPU.

Ported so far, on the float32 bucket layout. In 2-D: the WCSPH
mountain-wave flagship (``models.wcsph_perturbed_witch``), the three
pressure–entropy (Hopkins) schemes (``models.hopkins_perturbed_witch``,
``models.full_hopkins_perturbed_witch``, ``models.hopkins_total_witch`` with
``utils.packing.hydrostatic_packing``), the entropy-based (Pavelka) scheme
(``models.pavelka_total_witch`` with ``utils.packing.colagrossi_packing``),
the dam break (``models.collapse_dry``), the ISPH mountain wave
(``models.isph_witch``) and Rayleigh–Bénard convection
(``models.rayleigh_benard``). In 3-D, on the 27-cell stencil: the mountain
wave (``models.witch3d``) and the dam break (``models.collapse3d``). And the
terrain family (``models.legacy_witch``: isothermal and adiabatic, static
and flow, with inflow recycling and the sort rescatter). They run on
twenty-two hand-written pair sweeps. On the flat layout (rows sorted by
cell at every rebuild), in float32 or float64, every one of these also
runs, at its config's defaults, its pair sums taken by
``ops.apply.apply_binary`` in plain PyTorch (the reference takes XLA pair
sums there; Rayleigh–Bénard there also with the RKPM conduction of
``utils.rkpm``), and so does the implicit (ISPH) dam break
(``models.collapse_dry_implicit``), which has no bucket path; the flat
pressure solves take their operator from ``ops.solvers.assemble_matvec``.
Every scheme's ``run`` writes its files (``io``: PVD/VTP frames and
``data.csv``; ``utils.checkpoint``: bitwise checkpoint and resume).

The library surface is the reference's: ``algebra``, every kernel
function (``kernels``), shape (``geometry``) and lattice (``grids``), the
probe interpolation ``ops.apply.point_sum``, reversible fixed-point
arithmetic (``utils.fixpa``), velocity-entropy diagnostics
(``utils.entropy``), ICR renormalisation (``utils.icr``) and the frame
timer and profiler session (``utils.metrics``). Four of the canonical
examples run on it, flat and in float64 as their configs say: the
lid-driven cavity (``models.cavity_flow``, with ``point_sum`` probes), the
DFG cylinder (``models.cylinder``, inflow recycling into the spare rows),
the bit-reversible dam break (``models.collapse_symplectic``) and the
Kepler vortex (``models.kepler_vortex``).
"""
import torch

# No field value may go through reduced-precision matmul/conv paths.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .algebra import (  # noqa: E402
    VECX, VECY, VECZ, VEC0, MAT0, MAT1, FMAT0, FMAT1,
    RealVector, RealMatrix, FlatMatrix,
    dot, norm, trace, dev, det, trans, cof, inv, outer,
)
from .kernels import (  # noqa: E402
    wendland1, Dwendland1, rDwendland1,
    wendland2, Dwendland2, rDwendland2,
    wendland3, Dwendland3, rDwendland3, DDwendland3,
    spline23, Dspline23, rDspline23,
    spline24, Dspline24, rDspline24,
)
from .geometry import (  # noqa: E402
    Shape, Box, Rectangle, Circle, Ellipse, Ball, Ellipsoid, Cone,
    BooleanUnion, BooleanIntersection, BooleanDifference,
    Specification, BoundaryLayer, Transform, Polygon, ClosedSpline,
    RevolutionBody, Witch, is_inside, boundarybox,
)
from .grids import (  # noqa: E402
    Grid, Squaregrid, Hexagrid, VogelGrid, ExpGrid, Expgrid, CubicGrid,
    FacecenteredGrid, BodycenteredGrid, DiamondGrid, dimension, covering,
)
from .structs import ParticleState, ParticleSystem, generate_particles  # noqa: E402
from .ops.neighbors import NeighborEngine, Neighbors, sorted_slot_scatter  # noqa: E402
from .ops.apply import (  # noqa: E402
    apply_unary, apply_binary, pair_sum, point_sum, dist,
)
from .ops.solvers import (  # noqa: E402
    assemble_matvec, assemble_vector, cg_solve, assemble_matrix,
    assemble_matrix_bcoo,
)
from .interop import state_from_numpy, state_to_numpy  # noqa: E402
from .io import (  # noqa: E402
    DataStorage, new_pvd_file, save_pvd_file, save_frame, import_particles,
    read_vtp,
)

__version__ = "0.1.0"
