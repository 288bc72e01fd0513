from .calibration import calibrate  # noqa: F401
from .common import MLP, gather_nodes, scatter_mean, scatter_sum  # noqa: F401
from .critic import GraphValueNet, MLPValueNet  # noqa: F401
from .deepsets import DeepSets  # noqa: F401
from .gcn import GCN  # noqa: F401
from .hepi import HEPi  # noqa: F401
from .meshgraphnet import MeshGraphNet  # noqa: F401
from .mlp_policy import MLPCritic, MLPGaussianPolicy  # noqa: F401
from .policy import DiagGaussianPolicy  # noqa: F401
from .ponita_gcn import PonitaGCN  # noqa: F401
from .transformer import TransformerVanilla  # noqa: F401

MODEL_REGISTRY = {
    "hepi": HEPi,
    "ponita_gcn": PonitaGCN,  # the "EMPN" baseline
    "empn": PonitaGCN,
    "transformer": TransformerVanilla,
    "gcn": GCN,
    "deepsets": DeepSets,
    "meshgraphnet": MeshGraphNet,
}


def get_model(name: str, **kwargs):
    """Model factory keyed like the configs' `model`."""
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from None
    return cls(**kwargs)
