"""Collision constants shared by the port's plain versions and its kernels.

Counterpart of ``softbodyunity_tpu/solver/collide.py``; this slice needs only
its contact-shell constant (the position-level contact chain itself lives on
grid planes in :mod:`softbodyunity_torch.kernels.stencil`).
``tests/test_torch_xpbd_verlet.py`` holds the copy equal to the original.
"""

# Sphere-contact shell for position-level friction (oracle
# SPHERE_CONTACT_SHELL): projected vertices sit within ulps of the surface,
# so exact dist == r is a knife edge.
SPHERE_CONTACT_SHELL = 1.0 + 1e-5
