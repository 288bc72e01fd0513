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
from .kl import kl_diag_cov_projection  # noqa: F401
