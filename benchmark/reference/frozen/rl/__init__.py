from . import gaussian, projections  # noqa: F401
from .gae import gae  # noqa: F401
from .losses import LossInputs, clipped_value_loss, trpl_loss  # noqa: F401
from .normalizer import (  # noqa: F401
    MinMaxState,
    VecNormState,
    minmax_init,
    minmax_normalize,
    minmax_update,
    vecnorm_init,
    vecnorm_mean_std,
    vecnorm_normalize,
    vecnorm_update,
)
from .obs_pipeline import ObsNormState, obs_norm_apply, obs_norm_init, obs_norm_step  # noqa: F401
