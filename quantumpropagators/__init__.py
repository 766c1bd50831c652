"""quantumpropagators — a JAX framework for quantum dynamics.

A from-scratch JAX/XLA re-design of the capabilities of
``JuliaQuantumControl/QuantumPropagators.jl`` (reference mounted at
``/root/reference``): time propagation of quantum states under
time-dependent Hamiltonians / Liouvillians via Chebyshev, Newton
(restarted Krylov), and matrix-exponential methods, with a lazy
generator/operator algebra, piecewise-constant control semantics, an
interface-contract checking layer, and multi-chip state-vector sharding
over device meshes (one or several GPUs, or virtual CPU devices).
"""

from .config import use_cpu_x64
from .models.controls import (
    ParameterizedFunction,
    ParameterPartition,
    discretize,
    discretize_on_midpoints,
    evaluate,
    get_controls,
    get_parameters,
    get_tlist_midpoints,
    substitute,
    t_mid,
)
from .models.generators import (
    Generator,
    Operator,
    ScaledOperator,
    coeff_table,
    hamiltonian,
    liouvillian,
)
from .models.shapes import blackman, box, flattop
from .models.amplitudes import GuidedAmplitude, LockedAmplitude, ShapedAmplitude
from .models.crab import (
    CRABFunction,
    VariedFrequencyCRABFunction,
    crab_initial_parameters,
)
from .models.lattice import (
    GroupedSiteSum,
    SiteOperatorSum,
    transverse_field_ising,
    transverse_field_ising_2d,
)
from .ops.operators import (
    CSROperator,
    DIAOperator,
    dia_from_scipy,
    BSROperator,
    bsr_from_scipy,
    bsr_from_dense,
    choose_block_size,
    DiagonalOperator,
    StackedCSROperator,
    apply,
    csr_from_dense,
    csr_from_scipy,
    op_dot,
    to_dense,
)
from .ops.specrange import specrange
from .utils.iddict import IdDict

__version__ = "0.1.0"

# Propagator layer (imported late to avoid cycles)
from .propagators import init_prop, prop_step, reinit_prop, set_state, set_t  # noqa: E402
from .propagate import propagate, propagate_sequence, Propagation  # noqa: E402
from .storage import init_storage, map_observables, write_to_storage, get_from_storage  # noqa: E402

__all__ = [
    "use_cpu_x64",
    # controls
    "discretize",
    "discretize_on_midpoints",
    "get_tlist_midpoints",
    "t_mid",
    "evaluate",
    "get_controls",
    "get_parameters",
    "substitute",
    "ParameterizedFunction",
    "ParameterPartition",
    "IdDict",
    # shapes
    "flattop",
    "box",
    "blackman",
    # amplitudes & parameterized functions
    "LockedAmplitude",
    "ShapedAmplitude",
    "GuidedAmplitude",
    "CRABFunction",
    "VariedFrequencyCRABFunction",
    "crab_initial_parameters",
    # lattice models
    "SiteOperatorSum",
    "GroupedSiteSum",
    "transverse_field_ising",
    "transverse_field_ising_2d",
    # generators
    "Generator",
    "Operator",
    "ScaledOperator",
    "hamiltonian",
    "liouvillian",
    "coeff_table",
    # operators
    "CSROperator",
    "DIAOperator",
    "dia_from_scipy",
    "BSROperator",
    "bsr_from_scipy",
    "bsr_from_dense",
    "choose_block_size",
    "DiagonalOperator",
    "StackedCSROperator",
    "apply",
    "op_dot",
    "to_dense",
    "csr_from_dense",
    "csr_from_scipy",
    # methods
    "specrange",
    # propagation
    "init_prop",
    "prop_step",
    "reinit_prop",
    "set_state",
    "set_t",
    "propagate",
    "propagate_sequence",
    "Propagation",
    "init_storage",
    "map_observables",
    "write_to_storage",
    "get_from_storage",
]
