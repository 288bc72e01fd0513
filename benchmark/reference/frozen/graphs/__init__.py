from .homogenize import HomogeneousGraph, concat_features, homogenize  # noqa: F401
from .types import EdgeKey, EdgeSet, GraphFeatures, HeteroGraph, NodeSet  # noqa: F401
