"""Launchers of the port: ``train`` is the training driver, ``mesh`` builds
device meshes. The JAX package's dry-run and roofline launchers are not
ported yet (ROADMAP.md, queue 1)."""
