"""Launchers of the port: ``train`` is the training driver, ``mesh`` builds
device meshes, ``dryrun`` counts rank 0's step of every (arch x shape x
mesh) cell on fake tensors over a fake process group, and ``roofline``
turns its counts into the H100's three roofline terms. ``dryrun`` starts
its fake group only when a cell runs, and this package does not import
it."""
