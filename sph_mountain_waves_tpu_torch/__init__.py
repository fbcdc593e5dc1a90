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

Ported so far, all on the 2-D bucket layout: the WCSPH mountain-wave
flagship (``models.wcsph_perturbed_witch``), the three pressure–entropy
(Hopkins) schemes (``models.hopkins_perturbed_witch``,
``models.full_hopkins_perturbed_witch``, ``models.hopkins_total_witch`` with
``utils.packing.hydrostatic_packing``) and the entropy-based (Pavelka)
scheme (``models.pavelka_total_witch`` with
``utils.packing.colagrossi_packing``), on seven pair sweeps: density,
momentum, the Hopkins pressure root and momentum, the Pavelka continuity
and fused momentum + entropy sweeps and the packing's ∇Γ sum; and the file
output of every scheme's ``run`` (``io``: PVD/VTP frames and ``data.csv``;
``utils.checkpoint``: bitwise checkpoint and resume).
"""
import torch

# No field value may go through reduced-precision matmul/conv paths.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .geometry import (  # noqa: E402
    Shape, Box, Rectangle, Ball, BooleanUnion, BooleanDifference, Specification, BoundaryLayer, is_inside, boundarybox,
)
from .grids import Grid, Hexagrid, dimension, covering  # noqa: E402
from .kernels import wendland2, rDwendland2  # noqa: E402
from .structs import ParticleState, ParticleSystem, generate_particles  # noqa: E402
from .ops.neighbors import NeighborEngine, Neighbors  # noqa: E402
from .ops.apply import apply_unary  # noqa: E402
from .interop import state_from_numpy, state_to_numpy  # noqa: E402
from .io import (  # noqa: E402
    DataStorage, new_pvd_file, save_pvd_file, save_frame, import_particles,
    read_vtp,
)

__version__ = "0.1.0"
