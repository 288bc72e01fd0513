from .base import (  # noqa: F401
    BaseProjection,
    FrobeniusProjection,
    KLProjection,
    WassersteinProjection,
    entropy_equality_projection,
    entropy_inequality_projection,
    entropy_schedule,
    get_projection_layer,
    mean_projection,
)
from .fullcov import (  # noqa: F401
    FullCovKLProjection,
    FullCovW2NonCommutingProjection,
    kl_full_cov_projection,
    kl_full_joint_projection,
    w2_non_commutative_parts,
    w2_non_commutative_projection,
)
from .kl import kl_diag_cov_projection  # noqa: F401
