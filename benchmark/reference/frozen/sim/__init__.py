"""Batched simulator: scene state, constraint data and the cloth position
solve (CUDA kernel + plain PyTorch version)."""

from .types import (  # noqa: F401
    FixedJointSpec,
    ParticleState,
    RigidBodySpec,
    RigidBodyState,
    SceneState,
    axis_mask_from_bits,
    box_inertia,
)
from .xpbd import (  # noqa: F401
    BodyAttachment,
    BodyPairContact,
    ContactSet,
    DistanceGroup,
    ParticleSDFContact,
    ParticleSelfContact,
    ParticleSpec,
    step_physics,
    xpbd_substep,
)
