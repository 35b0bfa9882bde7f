"""Launchers of the port. ``train`` is the training driver; the JAX
package's mesh, dry-run and roofline launchers need a mesh and wait for
the distributed slice (ROADMAP.md, queue 1)."""
