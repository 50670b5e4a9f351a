from .sampling_kernel import (
    RSPlan,
    TickInputs,
    load_library,
    make_rs_plan,
    sampling_iteration_reference,
    sampling_rs,
)
from .sampling_softmax import (
    Knobs,
    make_knobs,
    sampling_chain,
    softmax_iteration,
    softmax_iteration_reference,
)

__all__ = [
    "Knobs",
    "RSPlan",
    "TickInputs",
    "load_library",
    "make_knobs",
    "make_rs_plan",
    "sampling_chain",
    "sampling_iteration_reference",
    "sampling_rs",
    "softmax_iteration",
    "softmax_iteration_reference",
]
