from ..declared import declared
from .calibration import calibrate  # noqa: F401
from .common import MLP, gather_nodes, scatter_mean, scatter_sum  # noqa: F401
from .critic import GraphValueNet, MLPValueNet  # noqa: F401
from .deepsets import DeepSets  # noqa: F401
from .hepi import HEPi  # noqa: F401
from .policy import DiagGaussianPolicy  # noqa: F401

MODEL_REGISTRY = {
    "hepi": HEPi,
    "deepsets": DeepSets,
}


def get_model(name: str, **kwargs):
    """Model factory keyed like the configs' `model`: the built-in models
    and those a module of this package declares in `MODELS`."""
    registry = declared(__name__, "MODELS", MODEL_REGISTRY, __file__)
    try:
        cls = registry[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(registry)}") from None
    return cls(**kwargs)
